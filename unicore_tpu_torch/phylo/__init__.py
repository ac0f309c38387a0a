"""Phylogenetic inference: the port of unicore_tpu/phylo."""
