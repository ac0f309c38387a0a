"""Per-gene fasta extraction from the proteome seqdb.

Contract of seq/create_gene_specific_fasta.rs:27-88: for every core-gene
list file ({gene}.txt with "member\tspecies" lines), write
{gene_dir}/{gene}/aa.fasta and 3di.fasta with records renamed to the
species (>species\nseq).  Missing members are fatal.

Copy of unicore_tpu/seq/gsf.py on the port's io/seqdb.py.
"""

from __future__ import annotations

import os
from typing import List

from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg


def create_gene_specific_fasta(input_db: str, gene_dir: str, gene_files: List[str]) -> None:
    db = SeqDB.read(input_db, require_ss=True)
    aa = dict(zip(db.names, db.aa_seqs))
    di = dict(zip(db.names, db.ss_seqs))

    for cnt, gene_path in enumerate(gene_files, 1):
        gene_name = os.path.splitext(os.path.basename(gene_path))[0]
        out_dir = os.path.join(gene_dir, gene_name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "aa.fasta"), "w") as fa, open(
            os.path.join(out_dir, "3di.fasta"), "w"
        ) as fd:
            with open(gene_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 2:
                        err.error(err.ERR_GENERAL, f"Invalid line in gene mapping file: {line.strip()}")
                    member, species = parts
                    if member not in aa or member not in di:
                        err.error(err.ERR_GENERAL, f"Sequence {species} not found in the database")
                    fa.write(f">{species}\n{aa[member]}\n")
                    fd.write(f">{species}\n{di[member]}\n")
        msg.print_message(f"\rCreating gene specific fasta files {cnt}/{len(gene_files)}...", 3)
    msg.println_message(f" Done\nGene specific fasta files prepared in: {gene_dir}", 3)
