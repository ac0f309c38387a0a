"""unicore-tpu-torch CLI — the parser of unicore_tpu/cli.py, and its ten
subcommands.

`build_parser` and `resolve` are copies of unicore_tpu's (the same
subcommands, flags, defaults and pre-wired paths), so a command line
means the same to both packages.  `run` dispatches all ten subcommands:
`createdb` (a ProstT5 model directory or `mock`, with the AFDB or custom
3Di lookups), `cluster` (the cascade above 5,000 sequences), `search`,
`profile`, `tree` (MSA, supermatrix and tree inference with the iqtree,
fasttree and raxml-ng schedules, partitioned with -p/-q), `gene-tree`
(batched per-gene inference), `config`, `easy-core`, `easy-search` and
`version`.

The device is chosen in runtime/device.py: CUDA, unless
UNICORE_TPU_TORCH_DEVICE=cpu asks for the CPU.  With
UNICORE_TPU_TORCH_COUNTERS=<file>, `main` writes the run's performance
counters and the SW kernel's launch counts to that file as JSON.
"""

from __future__ import annotations

import argparse
import os
import sys
from types import SimpleNamespace

from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import threads as thr


def _threshold(v: str) -> int:
    iv = int(v)
    if not 0 <= iv <= 100:
        raise argparse.ArgumentTypeError(f"{v} is not in range [0, 100]")
    return iv


def _bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--threads", type=int, default=0,
                   help="Number of threads to use; 0 to use all")
    p.add_argument("-v", "--verbosity", type=int, default=3,
                   help="Verbosity (0: quiet, 1: +errors, 2: +warnings, 3: +info, 4: +debug)")


def _add_easy_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", "--keep", action="store_true", help="Keep intermediate files")
    p.add_argument("-w", "--overwrite", action="store_true", help="Force overwrite output database")
    p.add_argument("--max-len", type=int, default=None, help="Set maximum sequence length threshold")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="Accelerator offload flag (the port runs on CUDA unless UNICORE_TPU_TORCH_DEVICE=cpu)")
    p.add_argument("--afdb-lookup", default=None, help="Use AFDB lookup for createdb. Useful for large databases")
    p.add_argument("--custom-lookup", default=None,
                   help="Use custom lookup database, accepts any seqdb to reference against")
    p.add_argument("-C", "--core-threshold", type=_threshold, default=80,
                   help="Coverage threshold for core structures. [0 - 100]")
    p.add_argument("-p", "--print-copiness", type=_bool, default=True,
                   help="Generate tsv with copy number statistics")
    p.add_argument("-A", "--aligner", default="foldmason",
                   help="Multiple sequence aligner [foldmason, mafft-linsi, mafft]")
    p.add_argument("-n", "--no-inference", action="store_true",
                   help="Stop the tree module after alignment (before tree inference)")
    p.add_argument("-T", "--tree-builder", default="iqtree",
                   help="Phylogenetic tree builder [iqtree, fasttree, raxml-ng]")
    p.add_argument("-a", "--aligner-options", default=None, help="Options for sequence aligner")
    p.add_argument("--tree-options", default=None,
                   help="Options for tree builder; defaults: iqtree '-m JTT+F+I+G -B 1000', "
                        "fasttree '-gamma -boot 1000', raxml-ng '--model JTT+F+I+G --seed 12345 --all --tree pars{90},rand{10}'")
    p.add_argument("-G", "--gap-threshold", type=_threshold, default=50,
                   help="Gap threshold for multiple sequence alignment [0 - 100]")
    _add_common(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="unicore-tpu-torch",
        description="Universal and efficient core gene phylogeny — PyTorch/CUDA engine",
    )
    sub = ap.add_subparsers(dest="command", metavar="MODULE")

    # easy-core
    p = sub.add_parser("easy-core", help="Easy core gene phylogeny workflow, from fasta files to phylogenetic tree")
    p.add_argument("input", help="Input directory with fasta files or a single fasta file")
    p.add_argument("output", help="Output directory where all results will be saved")
    p.add_argument("model", help="ProstT5 model directory ('mock' for the deterministic test backend)")
    p.add_argument("tmp", help="tmp directory")
    p.add_argument("-c", "--cluster-options", default="-c 0.8",
                   help='Arguments for clustering options in string e.g. -c "-c 0.8"')
    _add_easy_common(p)

    # easy-search
    p = sub.add_parser("easy-search", help="Easy search workflow, from fasta files to phylogenetic tree")
    p.add_argument("input", help="Input directory with fasta files or a single fasta file")
    p.add_argument("target", help="Target database to search against")
    p.add_argument("output", help="Output directory where all results will be saved")
    p.add_argument("model", help="ProstT5 model directory ('mock' for the deterministic test backend)")
    p.add_argument("tmp", help="tmp directory")
    p.add_argument("-s", "--search-options", default="-c 0.8",
                   help="Arguments for search options in string")
    _add_easy_common(p)

    # createdb
    p = sub.add_parser("createdb", help="Create 3Di database from amino-acid fasta input")
    p.add_argument("input", help="Input directory with fasta files or a single fasta file")
    p.add_argument("output", help="Output database path")
    p.add_argument("model", help="ProstT5 model directory ('mock' for the deterministic test backend)")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-w", "--overwrite", action="store_true")
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("-g", "--gpu", action="store_true")
    p.add_argument("--afdb-lookup", default=None)
    p.add_argument("--custom-lookup", default=None)
    _add_common(p)

    # cluster
    p = sub.add_parser("cluster", help="Cluster database all-vs-all by structural similarity")
    p.add_argument("input", help="Input database")
    p.add_argument("output", help="Output cluster path (writes {output}.tsv)")
    p.add_argument("tmp", help="tmp directory")
    p.add_argument("-k", "--keep-cluster-db", action="store_true")
    p.add_argument("-c", "--cluster-options", default="-c 0.8")
    _add_common(p)

    # search
    p = sub.add_parser("search", help="Search database against a reference core-structure DB")
    p.add_argument("input", help="Input (proteome) database")
    p.add_argument("target", help="Target (reference) database; acts as alignment query (search.rs:44-46)")
    p.add_argument("output", help="Output path (writes {output}.m8)")
    p.add_argument("tmp", help="tmp directory")
    p.add_argument("-k", "--keep-aln-db", action="store_true")
    p.add_argument("-s", "--search-options", default="-c 0.8")
    _add_common(p)

    # profile
    p = sub.add_parser("profile", help="Taxonomic profiling, identify core structures")
    p.add_argument("input_db", help="Proteome database (uses {db}.map)")
    p.add_argument("input_tsv", help="Cluster tsv or search m8 file")
    p.add_argument("output", help="Output directory")
    p.add_argument("-t", "--threshold", type=_threshold, default=80,
                   help="Coverage threshold for core structures. [0 - 100]")
    p.add_argument("-p", "--print-copiness", type=_bool, default=True)
    _add_common(p)

    # tree
    p = sub.add_parser("tree", help="Per-gene MSA, concatenation, and species tree inference")
    p.add_argument("db", help="Proteome database")
    p.add_argument("input", help="Profile output directory with core-gene .txt lists")
    p.add_argument("output", help="Output directory")
    p.add_argument("-A", "--aligner", default="foldmason")
    p.add_argument("-T", "--tree-builder", default="iqtree")
    p.add_argument("-o", "--aligner-options", default=None)
    p.add_argument("-n", "--no-inference", action="store_true")
    p.add_argument("-p", "--tree-options", default=None)
    p.add_argument("-d", "--threshold", type=_threshold, default=50,
                   help="Gap threshold for multiple sequence alignment [0 - 100]")
    _add_common(p)

    # gene-tree
    p = sub.add_parser("gene-tree", help="Per-gene phylogenetic trees")
    p.add_argument("input", help="tree module output directory (contains fasta/)")
    p.add_argument("-n", "--name", dest="names", default="", help="File with hashed gene names to include")
    p.add_argument("-T", "--tree-builder", default="iqtree")
    p.add_argument("-p", "--tree-options", default=None)
    p.add_argument("-f", "--realign", action="store_true")
    p.add_argument("-a", "--aligner", default="foldmason")
    p.add_argument("-o", "--aligner-options", default=None)
    p.add_argument("-d", "--threshold", type=_threshold, default=50)
    _add_common(p)

    # config
    p = sub.add_parser("config", help="Check and configure engines")
    p.add_argument("-c", "--check", action="store_true", help="Check engine availability and devices")
    for name in ("foldseek", "foldmason", "mafft", "mafft-linsi", "iqtree", "fasttree", "raxml-ng", "mmseqs"):
        p.add_argument(f"--set-{name}", default=None, help=f"Override engine '{name}' (module path or 'builtin')")
    _add_common(p)

    # version
    sub.add_parser("version", help="Print version and information")

    return ap


def resolve(ns: argparse.Namespace) -> SimpleNamespace:
    """Flatten the parsed subcommand into a resolved Args namespace with
    pre-wired module paths (the analog of arg_parser.rs:471-724)."""
    a = SimpleNamespace()
    cmd = ns.command
    a.command = cmd
    a.verbosity = getattr(ns, "verbosity", 3)
    a.threads = getattr(ns, "threads", 0)

    out = getattr(ns, "output", None)

    # createdb
    a.createdb_input = getattr(ns, "input", None) if cmd in ("createdb", "easy-core", "easy-search") else None
    a.createdb_output = (
        ns.output if cmd == "createdb"
        else f"{out}/proteome/proteome_db" if cmd in ("easy-core", "easy-search") else None
    )
    a.createdb_model = getattr(ns, "model", None)
    a.createdb_keep = getattr(ns, "keep", None)
    a.createdb_overwrite = getattr(ns, "overwrite", None)
    a.createdb_max_len = getattr(ns, "max_len", None)
    a.createdb_gpu = getattr(ns, "gpu", None)
    a.createdb_afdb_lookup = getattr(ns, "afdb_lookup", None)
    a.createdb_custom_lookup = getattr(ns, "custom_lookup", None)

    # profile
    if cmd == "profile":
        a.profile_input_db = ns.input_db
        a.profile_input_tsv = ns.input_tsv
        a.profile_output = ns.output
        a.profile_threshold = ns.threshold
        a.profile_print_copiness = ns.print_copiness
    elif cmd in ("easy-core", "easy-search"):
        a.profile_input_db = f"{out}/proteome/proteome_db"
        a.profile_input_tsv = (
            f"{out}/cluster/clust.tsv" if cmd == "easy-core" else f"{out}/search/search.m8"
        )
        a.profile_output = f"{out}/profile"
        a.profile_threshold = ns.core_threshold
        a.profile_print_copiness = ns.print_copiness

    # search
    if cmd == "search":
        a.search_input = ns.input
        a.search_target = ns.target
        a.search_output = ns.output
        a.search_tmp = ns.tmp
        a.search_keep_aln_db = ns.keep_aln_db
        a.search_search_options = ns.search_options
    elif cmd == "easy-search":
        a.search_input = f"{out}/proteome/proteome_db"
        a.search_target = ns.target
        a.search_output = f"{out}/search/search"
        a.search_tmp = ns.tmp
        a.search_keep_aln_db = ns.keep
        a.search_search_options = ns.search_options

    # cluster
    if cmd == "cluster":
        a.cluster_input = ns.input
        a.cluster_output = ns.output
        a.cluster_tmp = ns.tmp
        a.cluster_keep_cluster_db = ns.keep_cluster_db
        a.cluster_cluster_options = ns.cluster_options
    elif cmd == "easy-core":
        a.cluster_input = f"{out}/proteome/proteome_db"
        a.cluster_output = f"{out}/cluster/clust"
        a.cluster_tmp = ns.tmp
        a.cluster_keep_cluster_db = ns.keep
        a.cluster_cluster_options = ns.cluster_options

    # tree
    if cmd == "tree":
        a.tree_db = ns.db
        a.tree_input = ns.input
        a.tree_output = ns.output
        a.tree_aligner = ns.aligner
        a.tree_no_inference = ns.no_inference
        a.tree_tree_builder = ns.tree_builder
        a.tree_aligner_options = ns.aligner_options
        a.tree_tree_options = ns.tree_options
        a.tree_threshold = ns.threshold
    elif cmd in ("easy-core", "easy-search"):
        a.tree_db = f"{out}/proteome/proteome_db"
        a.tree_input = f"{out}/profile"
        a.tree_output = f"{out}/tree"
        a.tree_aligner = ns.aligner
        a.tree_no_inference = ns.no_inference
        a.tree_tree_builder = ns.tree_builder
        a.tree_aligner_options = ns.aligner_options
        a.tree_tree_options = ns.tree_options
        a.tree_threshold = ns.gap_threshold

    # gene-tree
    if cmd == "gene-tree":
        a.genetree_input = ns.input
        a.genetree_names = ns.names
        a.genetree_tree_builder = ns.tree_builder
        a.genetree_tree_options = ns.tree_options
        a.genetree_realign = ns.realign
        a.genetree_aligner = ns.aligner
        a.genetree_aligner_options = ns.aligner_options
        a.genetree_threshold = ns.threshold

    # config
    if cmd == "config":
        a.config_check = ns.check
        for name in ("foldseek", "foldmason", "mafft", "mafft_linsi", "iqtree", "fasttree", "raxml_ng", "mmseqs"):
            a.__setattr__(f"config_set_{name}", getattr(ns, f"set_{name.replace('_', '_')}", None))
        a.config_set_mafft_linsi = getattr(ns, "set_mafft_linsi", None)
        a.config_set_raxml_ng = getattr(ns, "set_raxml_ng", None)

    return a


PORTED = ("createdb", "cluster", "search", "profile", "tree", "gene-tree", "config",
          "easy-core", "easy-search", "version")


def run(args: SimpleNamespace) -> None:
    msg.set_verbosity(args.verbosity)
    thr.set_threads(args.threads or 0)
    # engines.cfg overrides govern which engine factories registry.get()
    # resolves — the analog of main.rs:12-15 loading path.cfg at startup.
    from unicore_tpu_torch.runtime import profiling, registry
    registry.load_overrides()

    cmd = args.command
    if cmd is None:
        build_parser().print_help()
        return
    if cmd == "version":
        from unicore_tpu_torch.modules import version
        version.run()
        return
    if cmd not in PORTED:
        err.error(err.ERR_UNKNOWN_MODULE, cmd)
    from unicore_tpu_torch.modules import (
        cluster, config, createdb, genetree, profile, search, tree,
    )
    from unicore_tpu_torch.workflow import easy_core, easy_search
    module = {"createdb": createdb, "cluster": cluster, "search": search,
              "profile": profile, "tree": tree, "gene-tree": genetree, "config": config,
              "easy-core": easy_core, "easy-search": easy_search}[cmd]
    with profiling.stage(cmd):
        module.run(args)


def _dump_counters() -> None:
    path = os.environ.get("UNICORE_TPU_TORCH_COUNTERS")
    if path:
        from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
        from unicore_tpu_torch.runtime import profiling
        profiling.dump(path, {**{f"kernel.sw.{k}.launches": v for k, v in sw_cuda.LAUNCHES.items()},
                              **{f"kernel.banded.{k}.launches": v
                                 for k, v in banded_cuda.LAUNCHES.items()},
                              **{f"kernel.dirbits.{k}.launches": v
                                 for k, v in dirbits_cuda.LAUNCHES.items()},
                              **dirbits_cuda.shape_counters()})


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    try:
        run(resolve(ns))
    except err.UnicoreError as e:
        return e.err_code
    except KeyboardInterrupt:
        return err.ERR_INTERRUPTED
    except Exception as e:  # noqa: BLE001 - map unexpected errors to the
        # reference's typed general-error exit (error_handler.rs:42-45)
        import traceback
        if msg.verbosity() >= 4:
            traceback.print_exc()
        msg.eprintln_message(err.build_message(err.ERR_GENERAL, str(e)), 1)
        return err.ERR_GENERAL
    _dump_counters()
    return 0


if __name__ == "__main__":
    sys.exit(main())
