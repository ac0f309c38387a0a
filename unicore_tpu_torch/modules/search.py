"""search — proteome DB vs reference core-structure DB.

Counterpart of unicore_tpu/modules/search.py.  Contract of
modules/search.rs:8-79 with the reference's **reversed query/target
convention**: the TARGET (reference) database acts as the
alignment query, so m8 column 1 = reference gene, column 2 = proteome
gene (search.rs:44-53; profile groups on column 1).

Output `{output}.m8`: BLAST tab format
  query target fident alnlen mismatch gapopen qstart qend tstart tend evalue bits
(1-based coordinates), grouped by query, best hits first.  Counters:
`search.candidate_pairs`, `search.hits` (after every gate).

Compute: the hashed k-mer prefilter of the reference DB against the
proteome DB, the engine's rescore, forward and reverse SW (the Hopper
kernel of ops/sw_cuda.py on CUDA, its plain version on the CPU; banded
above the long threshold), the E-value and coverage gate, then the exact
traceback of every gated hit for the m8 columns (`traceback_fill`).
"""

from __future__ import annotations

import os

import numpy as np

from unicore_tpu_torch.align.engine import AlignParams, encode_db
from unicore_tpu_torch.align.prefilter import candidate_pairs
from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling


def search_dbs(query_db: SeqDB, target_db: SeqDB, params: AlignParams):
    """Align query_db sequences against target_db; returns gated hits with
    m8 columns filled."""
    q_aa, q_ss = encode_db(query_db.aa_seqs, query_db.ss_seqs)
    t_aa, t_ss = encode_db(target_db.aa_seqs, target_db.ss_seqs)

    msg.print_message("Prefiltering candidate pairs...", 3)
    pairs = candidate_pairs(
        query_db.aa_seqs, query_db.ss_seqs,
        min_shared=params.min_shared_kmers,
        coverage=params.coverage if params.cov_mode == 0 else 0.0,
        target_aa=target_db.aa_seqs, target_ss=target_db.ss_seqs,
        sens=params.sens, max_seqs=params.max_seqs,
    )
    msg.println_message(f" {len(pairs)} pairs", 3)
    profiling.add_counter("search.candidate_pairs", len(pairs))

    from unicore_tpu_torch.runtime import registry
    engine = registry.get("foldseek")(params)
    hits = engine.align_pairs(q_aa, q_ss, t_aa, t_ss, pairs)
    qlen = np.array([len(a) for a in q_aa])
    tlen = np.array([len(a) for a in t_aa])
    kept = engine.gate(hits, qlen, tlen)
    engine.traceback_fill(kept, q_aa, q_ss, t_aa, t_ss)
    if params.min_seq_id > 0:
        kept = [h for h in kept if h.fident >= params.min_seq_id]
    kept.sort(key=lambda h: (h.qidx, h.evalue, -h.score, h.tidx))
    profiling.add_counter("search.hits", len(kept))
    return kept


def write_m8(path: str, hits, query_names, target_names) -> None:
    with open(path, "w") as f:
        for h in hits:
            f.write(
                f"{query_names[h.qidx]}\t{target_names[h.tidx]}\t"
                f"{h.fident:.3f}\t{h.alnlen}\t{h.mismatch}\t{h.gapopen}\t"
                f"{h.qstart + 1}\t{h.qend + 1}\t{h.tstart + 1}\t{h.tend + 1}\t"
                f"{h.evalue:.3E}\t{round(h.bits)}\n"
            )


def run(args) -> None:
    input_db = args.search_input
    target = args.search_target
    output = args.search_output
    keep = bool(args.search_keep_aln_db)
    options = args.search_search_options

    parent = os.path.dirname(output) or "."
    os.makedirs(parent, exist_ok=True)
    chkpnt.write_checkpoint(os.path.join(parent, "search.chk"), "0")

    proteome_db = SeqDB.read(input_db, require_ss=True)
    target_db = SeqDB.read(target, require_ss=True)
    params = AlignParams.from_options(options)

    # Reversed convention: the reference DB is the alignment query.
    hits = search_dbs(target_db, proteome_db, params)
    write_m8(output + ".m8", hits, target_db.names, proteome_db.names)

    if keep:
        # persist the intermediate alignment db in the reference's format
        # (query-keyed index, mmseqs alignment rows; search.rs:64-72)
        from unicore_tpu_torch.io.seqdb import write_aln_db
        qlen = [len(a) for a in target_db.aa_seqs]
        tlen = [len(a) for a in proteome_db.aa_seqs]
        write_aln_db(output + "_aln", hits, qlen, tlen)

    chkpnt.write_checkpoint(os.path.join(parent, "search.chk"), "1")
