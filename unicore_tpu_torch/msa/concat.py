"""Supermatrix concatenation + RAxML-style partition file.

Contract of seq/combine_fasta.rs:27-113:
  * inputs: list of per-gene filtered MSA fasta paths
    ({tree}/fasta/{gene}/{gene}.fa.filtered); the per-gene partition name
    ("hash") is the parent directory name of the MSA file
  * species absent from a gene are padded with '-' over that gene's block
  * partition line: "JTT+F+I+G, {gene}={start}-{end}" (1-based, inclusive)
  * outputs: {output}/combined.fasta + {output}/combined.fasta.partitions
  * species order: first-seen order across the gene files

Copy of unicore_tpu/msa/concat.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import os
from typing import Dict, List

from unicore_tpu_torch.io import fasta


def combine_fasta(fasta_files: List[str], output_dir: str) -> str:
    names: List[str] = []
    pos: Dict[str, int] = {}
    sequences: List[str] = []
    prev_len = 0

    out_fasta = os.path.join(output_dir, "combined.fasta")
    out_part = os.path.join(output_dir, "combined.fasta.partitions")

    with open(out_part, "w") as part:
        for path in fasta_files:
            path = path.strip()
            gene = os.path.basename(os.path.dirname(path)) or "unknown"
            records = fasta.read_fasta(path)
            add_this = 0
            for name, seq in records.items():
                name = name.strip()
                add_this = len(seq)
                if name in pos:
                    p = pos[name]
                    if len(sequences[p]) != prev_len:
                        sequences[p] = sequences[p] + "-" * (prev_len - len(sequences[p]))
                    sequences[p] += seq
                else:
                    pos[name] = len(names)
                    names.append(name)
                    sequences.append("-" * prev_len + seq)
            part.write(f"JTT+F+I+G, {gene}={prev_len + 1}-{prev_len + add_this}\n")
            prev_len += add_this
            for i in range(len(sequences)):
                if len(sequences[i]) < prev_len:
                    sequences[i] += "-" * (prev_len - len(sequences[i]))

    with open(out_fasta, "w") as out:
        for name, seq in zip(names, sequences):
            out.write(f">{name}\n{seq}\n")
    return out_fasta
