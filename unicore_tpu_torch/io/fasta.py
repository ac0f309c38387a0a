"""FASTA reading/writing.

Behavioral contract mirrors seq/fasta_io.rs:6-48:
  * read_fasta returns {header-without-'>': concatenated-sequence};
    later duplicate headers overwrite earlier ones (HashMap semantics).
  * write_fasta writes ">header\nseq\n" per record; `sort` sorts headers
    lexicographically, otherwise insertion order is used (Python dicts
    preserve insertion order; the reference's HashMap order is arbitrary,
    so any order is contract-compatible — we pick insertion for
    determinism).

Copy of unicore_tpu/io/fasta.py (the port imports nothing of the JAX
package); the pure-Python path is the only one here.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    header = None
    chunks: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            else:
                chunks.append(line.strip())
    if header is not None:
        yield header, "".join(chunks)


def read_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, str] = {}
    for h, s in iter_fasta(path):
        seqs[h] = s
    return seqs


def write_fasta(path: str, mapping: Dict[str, str], sort: bool = False) -> None:
    headers = list(mapping.keys())
    if sort:
        headers.sort()
    with open(path, "w") as f:
        for h in headers:
            f.write(f">{h}\n{mapping[h]}\n")
