"""tree — per-gene MSA, gap filter, concatenation, species-tree inference.

Counterpart of unicore_tpu/modules/tree.py (stage contract of
modules/tree.rs:17-163):
  * read `{input}/*.txt` core-gene lists
  * create per-gene fastas ({output}/fasta/{gene}/{aa,3di}.fasta) with
    species-renamed records (tree.rs:63-69)
  * foldmason aligner additionally materializes per-gene seqdbs
    ({gene}_db, {gene}_db_ss; tree.rs:78-110)
  * MSA per gene (foldmason -> {gene}_aa.fa + {gene}_3di.fa;
    mafft/mafft-linsi -> {gene}.fa), then gap-filter ->
    {gene}.fa.filtered (threshold semantics of tree.rs:299-331)
  * combine_fasta -> combined.fasta + .partitions (tree.rs:130)
  * skip-alignment fast path when combined.fasta exists (tree.rs:55-57);
    --no-inference early return (tree.rs:132-134)
  * tree builder (iqtree, fasttree, raxml-ng: phylo/engine.py on the
    engine's device) with default options (tree.rs:140-157) writing the
    per-builder output files, under the profiling stage `tree.inference`
  * checkpoints tree.chk 0/1

Tree options naming a partition file (-p/-q) are not ported yet: a run
that would reach inference with them exits with
ERR_MODULE_NOT_IMPLEMENTED before it writes anything.
"""

from __future__ import annotations

import os
from typing import List

from unicore_tpu_torch.io import fasta
from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.msa.concat import combine_fasta
from unicore_tpu_torch.msa.gapfilter import filter_msa
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.seq.gsf import create_gene_specific_fasta

DEFAULT_TREE_OPTIONS = {
    "iqtree": "-m JTT+F+I+G -B 1000",
    "raxml-ng": "--model JTT+F+I+G --seed 12345 --all --tree pars{90},rand{10}",
    "fasttree": "-gamma -boot 1000",
}


def _tree_options(tree_builder: str, tree_options) -> str:
    return tree_options if tree_options else DEFAULT_TREE_OPTIONS.get(
        tree_builder, DEFAULT_TREE_OPTIONS["iqtree"]
    )


def _msa_engine(aligner: str, options):
    """Resolve the MSA engine through the registry (lets tests and
    engines.cfg swap implementations, the analog of path.cfg)."""
    from unicore_tpu_torch.runtime import registry

    if aligner not in ("foldmason", "mafft", "mafft-linsi"):
        err.error(err.ERR_GENERAL, "Unrecognized aligner")
    return registry.get(aligner)()


def run_aligner(
    aligner: str, gene_fasta_dir: str, gene_files: List[str],
    aligner_options, threshold: int,
) -> None:
    """Align every gene dir; writes the per-aligner MSA files + .filtered.

    Engines exposing `align_many` (the progressive MSA) get ALL genes in
    one call, so every merge round batches across genes into a single
    device dispatch (tree.rs:166-231 hot loop, device-resident)."""
    engine = _msa_engine(aligner, aligner_options)

    genes = []  # (gene_name, gene_dir, names, seqs, ss_or_None, di_map)
    for gene_path in gene_files:
        gene_name = os.path.splitext(os.path.basename(gene_path))[0]
        gene_dir = os.path.join(gene_fasta_dir, gene_name)
        aa = fasta.read_fasta(os.path.join(gene_dir, "aa.fasta"))
        names = list(aa.keys())
        seqs = [aa[n] for n in names]
        if aligner == "foldmason":
            di = fasta.read_fasta(os.path.join(gene_dir, "3di.fasta"))
            ss = [di.get(n, "X" * len(aa[n])) for n in names]
        else:
            di, ss = None, None
        genes.append((gene_name, gene_dir, names, seqs, ss, di))

    if hasattr(engine, "align_many"):
        msg.print_message(f"\rAligning genes 0/{len(gene_files)} (batched)...", 3)
        all_aligned = engine.align_many(
            [(names, seqs, ss) for (_, _, names, seqs, ss, _) in genes]
        )
    else:
        all_aligned = [
            engine.align(names, seqs, ss) if ss is not None else engine.align(names, seqs)
            for (_, _, names, seqs, ss, _) in genes
        ]

    for i, ((gene_name, gene_dir, names, seqs, ss, di), aligned) in enumerate(
        zip(genes, all_aligned), 1
    ):
        if aligner == "foldmason":
            msa_file = os.path.join(gene_dir, f"{gene_name}_aa.fa")
            # aligned 3Di strings (same gap structure) for parity
            di_out = {}
            for r, n in enumerate(names):
                s = aligned[n]
                src = iter(di.get(n, "X" * len(seqs[r])))
                di_out[n] = "".join("-" if c == "-" else next(src) for c in s)
            fasta.write_fasta(os.path.join(gene_dir, f"{gene_name}_3di.fa"), di_out)
        else:
            msa_file = os.path.join(gene_dir, f"{gene_name}.fa")
        fasta.write_fasta(msa_file, aligned)
        filter_msa(msa_file, os.path.join(gene_dir, f"{gene_name}.fa.filtered"), threshold)
        msg.print_message(f"\rAligning genes {i}/{len(gene_files)}...", 3)
    msg.println_message(" Done", 3)


def run_tree_builder(
    tree_builder: str, output_dir: str, msa_fasta: str, tree_options, threads: int = 0
) -> str:
    from unicore_tpu_torch.runtime import registry

    if tree_builder not in DEFAULT_TREE_OPTIONS and tree_builder != "raxml":
        err.error(err.ERR_GENERAL, "Unrecognized tree builder")
    options = _tree_options(tree_builder, tree_options)
    name = "raxml-ng" if tree_builder == "raxml" else tree_builder
    engine = registry.get(name)()
    return engine.run_file(msa_fasta, output_dir, options=options, threads=threads)


def check_ported(args) -> None:
    """The typed exit for tree options the port does not run yet (a
    partition file), where the run would reach inference; raised before
    anything is written."""
    combined = os.path.join(args.tree_output, "combined.fasta")
    if not args.tree_no_inference or os.path.isfile(combined):
        from unicore_tpu_torch.phylo.engine import check_ported_options
        check_ported_options(_tree_options(args.tree_tree_builder, args.tree_tree_options))


def run(args) -> None:
    db = args.tree_db
    input_dir = args.tree_input
    output = args.tree_output
    aligner = args.tree_aligner
    no_inference = bool(args.tree_no_inference)
    tree_builder = args.tree_tree_builder
    aligner_options = args.tree_aligner_options
    tree_options = args.tree_tree_options
    threshold = args.tree_threshold

    combined = os.path.join(output, "combined.fasta")
    check_ported(args)

    os.makedirs(output, exist_ok=True)
    chkpnt.write_checkpoint(os.path.join(output, "tree.chk"), "0")

    if not os.path.isfile(combined):
        gene_fasta_dir = os.path.join(output, "fasta")
        os.makedirs(gene_fasta_dir, exist_ok=True)
        gene_files = sorted(
            os.path.join(input_dir, f)
            for f in os.listdir(input_dir)
            if f.endswith(".txt")
        )
        if not gene_files:
            err.error(err.ERR_GENERAL, f"No core gene lists (*.txt) found in {input_dir}")
        create_gene_specific_fasta(db, gene_fasta_dir, gene_files)

        if aligner == "foldmason":
            # materialize per-gene seqdbs (parity with tree.rs:78-110)
            for gene_path in gene_files:
                gene_name = os.path.splitext(os.path.basename(gene_path))[0]
                gene_dir = os.path.join(gene_fasta_dir, gene_name)
                aa = fasta.read_fasta(os.path.join(gene_dir, "aa.fasta"))
                di = fasta.read_fasta(os.path.join(gene_dir, "3di.fasta"))
                names = list(aa.keys())
                SeqDB(
                    names=names,
                    aa_seqs=[aa[n] for n in names],
                    ss_seqs=[di[n] for n in names],
                ).write(os.path.join(gene_dir, f"{gene_name}_db"))

        run_aligner(aligner, gene_fasta_dir, gene_files, aligner_options, threshold)

        msa_list = [
            os.path.join(
                gene_fasta_dir,
                os.path.splitext(os.path.basename(g))[0],
                os.path.splitext(os.path.basename(g))[0] + ".fa.filtered",
            )
            for g in gene_files
        ]
        combine_fasta(msa_list, output)

        if no_inference:
            return
    else:
        msg.println_message(
            f"Concatenated alignment file {combined} already exists, skipping alignment step", 3
        )

    msg.print_message("Inferring phylogenetic tree...", 3)
    with profiling.stage("tree.inference"):
        run_tree_builder(tree_builder, output, combined, tree_options)
    msg.println_message(" Done", 3)

    chkpnt.write_checkpoint(os.path.join(output, "tree.chk"), "1")
