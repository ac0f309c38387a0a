"""The port's `tree` and `easy-core` through unicore_tpu_torch's CLI
against unicore_tpu's CLI on the same proteomes.  Every file before
inference (per-gene fastas, seqdbs, MSAs, filtered MSAs, combined.fasta
and its partitions) must be byte-identical, and so must the file set.
The inference outputs (iqtree.treefile/.iqtree/.log, fasttree.nwk,
raxml-ng.raxml.bestTree/.support) are compared after parsing: the same
topology (RF 0), branch lengths and UFBoot supports within the
tolerances of torch_port_helpers, lnL within BLEN_LL_RTOL, every other
report line equal except `seconds`."""

import shutil

import pytest

from torch_port_helpers import (  # noqa: F401
    BLEN_LL_RTOL, assert_same_tree, files_of, one_torch_thread, port_env, write_proteomes,
)
from unicore_tpu.cli import main as jax_main
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.runtime import profiling


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """`python -m unicore_tpu easy-core IN OUT mock TMP -n` on the
    four-species fixture, once for the module: the reference of the
    easy-core test, and the database and core genes of the tree tests."""
    root = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(root / "home"))
        write_proteomes(root / "in")
        assert jax_main(["easy-core", str(root / "in"), str(root / "out"), "mock",
                         str(root / "tmp"), "-n", "-v", "1"]) == 0
    return root


def _assert_same_files(ref_root, out_root):
    ref, out = files_of(ref_root), files_of(out_root)
    assert sorted(ref) == sorted(out)
    for name in sorted(ref):
        assert ref[name] == out[name], name
    return out


@pytest.mark.parametrize("aligner", ["foldmason", "mafft", "mafft-linsi"])
def test_tree_no_inference_matches_jax(port_env, jax_run, aligner):  # noqa: F811
    db = str(jax_run / "out" / "proteome" / "proteome_db")
    argv = ["tree", db, str(jax_run / "out" / "profile")]
    opts = ["-n", "-A", aligner, "-v", "1"]
    assert jax_main(argv + [str(port_env / "jax_tree")] + opts) == 0
    profiling.reset_counters()
    assert port_main(argv + [str(port_env / "port_tree")] + opts) == 0

    out = _assert_same_files(port_env / "jax_tree", port_env / "port_tree")
    genes = sorted(p.name for p in (jax_run / "out" / "profile").glob("*.txt"))
    assert len(genes) >= 3
    msa = "_aa.fa" if aligner == "foldmason" else ".fa"
    for g in genes:
        gene = g[:-4]
        assert f"fasta/{gene}/{gene}{msa}" in out and f"fasta/{gene}/{gene}.fa.filtered" in out
    assert (aligner == "foldmason") == any(n.endswith("_3di.fa") for n in out)
    assert {"combined.fasta", "combined.fasta.partitions", "tree.chk"} <= set(out)
    counters = profiling.get_counters()
    assert counters["msa.dispatches"] > 0 and counters["msa.cells"] > 0
    assert counters["msa.nw.seconds"] > 0 and counters["msa.seconds"] > 0


def test_easy_core_no_inference_matches_jax(port_env, jax_run):  # noqa: F811
    assert port_main(["easy-core", str(jax_run / "in"), str(port_env / "out"), "mock",
                      str(port_env / "tmp"), "-n", "-v", "1"]) == 0
    out = _assert_same_files(jax_run / "out", port_env / "out")
    assert {"cluster/clust.tsv", "profile/copiness.tsv", "tree/combined.fasta",
            "tree/combined.fasta.partitions"} <= set(out)
    assert out["tree/tree.chk"] == b"0"  # -n returns before the checkpoint's "1"


INFERENCE = {"iqtree": ("iqtree.treefile", "iqtree.iqtree", "iqtree.log"),
             "fasttree": ("fasttree.nwk",),
             "raxml-ng": ("raxml-ng.raxml.bestTree", "raxml-ng.raxml.support")}


def _report(text):
    return dict(line.split(": ", 1) for line in text.decode().splitlines() if ": " in line)


def _assert_same_outputs(ref_root, out_root):
    """Byte-identical files, except the inference outputs, which are
    compared after parsing; returns the port's files."""
    ref, out = files_of(ref_root), files_of(out_root)
    assert sorted(ref) == sorted(out)
    for name in sorted(ref):
        base = name.rsplit("/", 1)[-1]
        if base in ("iqtree.treefile", "fasttree.nwk", "raxml-ng.raxml.support",
                    "raxml-ng.raxml.bestTree"):
            assert_same_tree(ref[name].decode(), out[name].decode(),
                             supported=not base.endswith("bestTree"))
        elif base in ("iqtree.iqtree", "iqtree.log"):
            a, b = _report(ref[name]), _report(out[name])
            assert abs(float(b.pop("lnL")) - float(a["lnL"])) <= BLEN_LL_RTOL * abs(float(a.pop("lnL")))
            del a["seconds"], b["seconds"]
            assert a == b, name
        else:
            assert ref[name] == out[name], name
    return out


def test_easy_core_matches_jax(port_env, jax_run, tmp_path):  # noqa: F811
    """easy-core with its defaults (iqtree, -m JTT+F+I+G -B 1000) from
    scratch; the JAX reference finishes its `-n` run on a copy (the tree
    stage's checkpoint reads 0, so it reruns and takes the skip path)."""
    ref = tmp_path / "jax_full"
    shutil.copytree(jax_run / "out", ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(jax_run / "home"))
        assert jax_main(["easy-core", str(jax_run / "in"), str(ref), "mock",
                         str(tmp_path / "jax_tmp"), "-v", "1"]) == 0
    profiling.reset_counters()
    assert port_main(["easy-core", str(jax_run / "in"), str(port_env / "out"), "mock",
                      str(port_env / "tmp"), "-v", "1"]) == 0
    out = _assert_same_outputs(ref, port_env / "out")
    assert {f"tree/{f}" for f in INFERENCE["iqtree"]} <= set(out)
    assert out["tree/tree.chk"] == b"1"
    counters = profiling.get_counters()
    assert counters["stage.tree.inference.seconds"] > 0
    assert counters["phylo.seconds"] > 0 and counters["phylo.patterns"] > 0
    assert counters["phylo.candidates"] > 0 and counters["phylo.blen_steps"] > 0


@pytest.mark.parametrize("builder", ["iqtree", "fasttree", "raxml-ng"])
def test_tree_builders_skip_path_match_jax(port_env, jax_run, builder):  # noqa: F811
    """`tree -T BUILDER` (default options) where combined.fasta exists:
    the alignment is skipped, inference runs alone, tree.chk reads 1."""
    src = jax_run / "out" / "tree"
    for d in ("jax", "port"):
        (port_env / d).mkdir()
        for f in ("combined.fasta", "combined.fasta.partitions"):
            shutil.copy(src / f, port_env / d / f)
    argv = ["tree", str(jax_run / "out" / "proteome" / "proteome_db"), str(jax_run / "out" / "profile")]
    opts = ["-T", builder, "-v", "1"]
    assert jax_main(argv + [str(port_env / "jax")] + opts) == 0
    assert port_main(argv + [str(port_env / "port")] + opts) == 0
    out = _assert_same_outputs(port_env / "jax", port_env / "port")
    assert set(out) == {"combined.fasta", "combined.fasta.partitions", "tree.chk", *INFERENCE[builder]}
    assert out["tree.chk"] == b"1"


def test_tree_partition_options_exit_before_writing(port_env, jax_run):  # noqa: F811
    """Partitioned models (-p/-q in the tree options) were the typed "not
    yet ported" exit of `tree` and `easy-core`; both now run them.  On
    copies of the fixture's `-n` output (supermatrix and partition file
    in place: the skip path), `tree -q` and `easy-core -p` (its createdb,
    cluster and profile skipped by their checkpoints) through both CLIs:
    the same files, the inference outputs compared after parsing, and
    n_partitions the partition file's line count."""
    n_parts = len((jax_run / "out" / "tree" / "combined.fasta.partitions").read_text().splitlines())
    for flag, cmd in (("-q", "tree"), ("-p", "easy-core")):
        for main, side in ((jax_main, "jax"), (port_main, "port")):
            out = port_env / flag / side
            shutil.copytree(jax_run / "out", out)
            opts = ["--tree-options", f"-m JTT+F+G -B 50 {flag} {out / 'tree' / 'combined.fasta.partitions'}",
                    "-v", "0"]
            if cmd == "tree":
                argv = ["tree", str(out / "proteome" / "proteome_db"), str(out / "profile"), str(out / "tree")]
            else:
                argv = ["easy-core", str(jax_run / "in"), str(out), "mock", str(port_env / flag / "tmp")]
            assert main(argv + opts) == 0
        got = _assert_same_outputs(port_env / flag / "jax", port_env / flag / "port")
        assert got["tree/tree.chk"] == b"1"
        assert _report(got["tree/iqtree.iqtree"])["n_partitions"] == str(n_parts) and n_parts >= 3