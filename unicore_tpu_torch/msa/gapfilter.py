"""MSA gap-column filter.

Contract of tree.rs:299-331 (`filter_msa`): keep column i iff
    non_gap_count[i] * 100 >= threshold * n_sequences
(>= comparison, integer arithmetic).  Reads/writes FASTA; the reference
writes records in HashMap order — we preserve input order.

Copy of unicore_tpu/msa/gapfilter.py (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from unicore_tpu_torch.io import fasta


def filter_columns(msa: Dict[str, str], threshold: int) -> Dict[str, str]:
    if not msa:
        return {}
    seqs = list(msa.values())
    n = len(seqs)
    L = len(seqs[0])
    arr = np.frombuffer("".join(seqs).encode(), dtype=np.uint8).reshape(n, L)
    non_gap = (arr != ord("-")).sum(axis=0)
    keep = non_gap * 100 >= threshold * n
    out = {}
    for h, s in msa.items():
        b = np.frombuffer(s.encode(), dtype=np.uint8)[keep]
        out[h] = b.tobytes().decode()
    return out


def filter_msa(input_msa: str, output_msa: str, threshold: int) -> None:
    msa = fasta.read_fasta(input_msa)
    out = filter_columns(msa, threshold)
    with open(output_msa, "w") as f:
        for h, s in out.items():
            f.write(f">{h}\n{s}\n")
