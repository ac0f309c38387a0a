"""gene-tree — per-gene phylogenetic trees.

Counterpart of unicore_tpu/modules/genetree.py (contract of
modules/genetree.rs:9-146):
  * input = tree-module output dir; requires {input}/fasta/
  * optional --name file with hashed gene names to subset (:50-83)
  * optional --realign re-runs the aligner with a custom gap threshold
  * deletes stale `iqtree*` outputs per gene dir before inference
  * runs the tree builder per gene MSA ({gene}.fa.filtered), all genes in
    one batched call where the engine has `run_files` (phylo/genebatch.py);
    default options include the reference's classic-raxml branch
    (genetree.rs:45: "raxml" uses "-m PROTCATJTT -p 12345 -x 12345 -f a
    -N 1000" — both "raxml" and "raxml-ng" map to the raxml-ng schedule)
"""

from __future__ import annotations

import os

from unicore_tpu_torch.modules.tree import DEFAULT_TREE_OPTIONS, run_aligner, run_tree_builder
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg

DEFAULT_GENETREE_OPTIONS = {
    "iqtree": "-m JTT+F+I+G -B 1000",
    "raxml": "-m PROTCATJTT -p 12345 -x 12345 -f a -N 1000",
    "fasttree": "-gamma -boot 1000",
}


def run(args) -> None:
    input_dir = args.genetree_input
    names = args.genetree_names
    tree_builder = args.genetree_tree_builder
    tree_options = args.genetree_tree_options
    realign = bool(args.genetree_realign)
    aligner = args.genetree_aligner
    aligner_options = args.genetree_aligner_options
    threshold = args.genetree_threshold

    if not os.path.isdir(input_dir):
        err.error(err.ERR_GENERAL, "Input directory does not exist")
    gene_fasta_dir = os.path.join(input_dir, "fasta")
    if not os.path.isdir(gene_fasta_dir):
        err.error(err.ERR_GENERAL, "Input directory does not contain core structure fasta directories")

    if not tree_options:
        tree_options = DEFAULT_GENETREE_OPTIONS.get(tree_builder)
        if tree_options is None and tree_builder != "raxml-ng":
            err.error(err.ERR_GENERAL, "Unrecognized tree builder")
    names_list = []
    if names:
        if not os.path.isfile(names):
            err.error(err.ERR_GENERAL, "Names file does not exist")
        with open(names) as f:
            names_list = [l.strip() for l in f if l.strip()]

    gene_dirs = sorted(
        d for d in os.listdir(gene_fasta_dir)
        if os.path.isdir(os.path.join(gene_fasta_dir, d))
    )
    if names_list:
        gene_dirs = [g for g in gene_dirs if g in names_list]
        if not gene_dirs:
            err.error(err.ERR_GENERAL, "No gene names matched")

    if realign:
        gene_files = [os.path.join(gene_fasta_dir, g + ".txt") for g in gene_dirs]
        run_aligner(aligner, gene_fasta_dir, gene_files, aligner_options, threshold)

    msa_files, out_dirs = [], []
    for gene in gene_dirs:
        gene_dir = os.path.join(gene_fasta_dir, gene)
        msa = os.path.join(gene_dir, f"{gene}.fa.filtered")
        if not os.path.isfile(msa):
            err.error(err.ERR_FILE_NOT_FOUND, msa)
        # delete stale iqtree outputs (genetree.rs:117-131)
        stale = [f for f in os.listdir(gene_dir) if f.startswith("iqtree")]
        if stale:
            msg.println_message(
                f"Warning: IQ-TREE output already exists. Deleting IQ-TREE results in {gene_dir}", 2
            )
            for f in stale:
                os.remove(os.path.join(gene_dir, f))
        msa_files.append(msa)
        out_dirs.append(gene_dir)

    builder = "raxml-ng" if tree_builder == "raxml" else tree_builder
    if not tree_options:
        # mirror run_tree_builder's substitution (the raxml-ng branch has
        # no DEFAULT_GENETREE_OPTIONS entry and must not lose --all)
        tree_options = DEFAULT_TREE_OPTIONS.get(builder, DEFAULT_TREE_OPTIONS["iqtree"])
    from unicore_tpu_torch.runtime import registry
    engine = registry.get(builder)()
    if hasattr(engine, "run_files"):
        # batched inference: genes grouped by (taxa, pattern bucket),
        # lockstep NNI per group (genetree.rs:113-143 was one full
        # process per gene)
        msg.print_message(
            f"\rInferring gene specific phylogenetic trees ({len(gene_dirs)} genes, batched)...", 3
        )
        engine.run_files(msa_files, out_dirs, options=tree_options)
    else:
        msg.print_message(f"\rInferring gene specific phylogenetic trees 0/{len(gene_dirs)}...", 3)
        for i, (msa, gene_dir) in enumerate(zip(msa_files, out_dirs), 1):
            run_tree_builder(builder, gene_dir, msa, tree_options)
            msg.print_message(f"\rInferring gene specific phylogenetic trees {i}/{len(gene_dirs)}...", 3)
    msg.println_message("Done", 3)
