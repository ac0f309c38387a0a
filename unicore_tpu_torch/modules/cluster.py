"""cluster — all-vs-all structural clustering.

Pipeline contract of modules/cluster.rs:9-83:
  * input: seqdb triplet; options string (default "-c 0.8")
  * output: `{output}.tsv` with "representative\tmember" lines grouped by
    representative (the foldseek cluster + createtsv composition), plus an
    intermediate `{output}_cluster` db kept only with --keep
  * checkpoints cluster.chk ("0" start, "1" done) in the output's parent

Counterpart of unicore_tpu/modules/cluster.py.  Compute: hashed k-mer
prefilter (one gram product on the device), batched prefix-scan
Smith-Waterman (the Hopper kernel of ops/sw_cuda.py on CUDA, its plain
version on the CPU), coverage/E-value gating, greedy set cover.  The
cascade for more than CASCADE_THRESHOLD sequences is not yet ported.
"""

from __future__ import annotations

import os

from unicore_tpu_torch.align.clustering import greedy_set_cover, write_cluster_tsv
from unicore_tpu_torch.align.engine import AlignParams, encode_db
from unicore_tpu_torch.align.prefilter import candidate_pairs
from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling

import numpy as np


CASCADE_THRESHOLD = 5000  # above this, use the linclust-style cascade


def cluster_db(db: SeqDB, params: AlignParams, cascade_threshold: int = CASCADE_THRESHOLD):
    """Run the clustering compute; returns ({rep: members}, hits)."""
    n = len(db)
    if not db.has_ss:
        err.error(err.ERR_DB_INVALID, "3Di sequences required for structural clustering")

    if n > cascade_threshold:
        err.error(err.ERR_MODULE_NOT_IMPLEMENTED,
                  f"{n} sequences need the cascade (more than {cascade_threshold}); "
                  "cascade not yet ported to unicore_tpu_torch")

    msg.print_message("Prefiltering candidate pairs...", 3)
    pairs = candidate_pairs(
        db.aa_seqs, db.ss_seqs,
        min_shared=params.min_shared_kmers,
        coverage=params.coverage if params.cov_mode == 0 else 0.0,
        sens=params.sens, max_seqs=params.max_seqs,
    )
    msg.println_message(f" {len(pairs)} pairs from {n * (n - 1) // 2}", 3)
    profiling.add_counter("cluster.sequences", n)
    profiling.add_counter("cluster.candidate_pairs", len(pairs))

    q_aa, q_ss = encode_db(db.aa_seqs, db.ss_seqs)
    from unicore_tpu_torch.runtime import registry
    engine = registry.get("foldseek")(params)
    msg.print_message("Aligning candidate pairs...", 3)
    hits = engine.align_pairs(q_aa, q_ss, q_aa, q_ss, pairs)
    msg.println_message(" Done", 3)

    qlen = np.array([len(a) for a in q_aa])
    kept = engine.gate(hits, qlen, qlen)
    if params.min_seq_id > 0:
        engine.traceback_fill(kept, q_aa, q_ss, q_aa, q_ss)
        kept = [h for h in kept if h.fident >= params.min_seq_id]
    edges = [(h.qidx, h.tidx) for h in kept]
    clusters = greedy_set_cover(n, edges)
    profiling.add_counter("cluster.hits", len(kept))
    profiling.add_counter("cluster.clusters", len(clusters))
    msg.println_message(f"{len(clusters)} clusters from {n} sequences", 3)
    return clusters, kept


def run(args) -> None:
    input_db = args.cluster_input
    output = args.cluster_output
    keep = bool(args.cluster_keep_cluster_db)
    options = args.cluster_cluster_options

    parent = os.path.dirname(output) or "."
    os.makedirs(parent, exist_ok=True)
    chkpnt.write_checkpoint(os.path.join(parent, "cluster.chk"), "0")

    db = SeqDB.read(input_db, require_ss=True)
    params = AlignParams.from_options(options)

    msg.print_message("Running structural clustering...", 3)
    msg.println_message("", 3)
    clusters, _ = cluster_db(db, params)

    write_cluster_tsv(output + ".tsv", clusters, db.names)

    if keep:
        # persist the intermediate cluster db in the reference's format
        # (rep-keyed index, member ids per record; io/seqdb.py)
        from unicore_tpu_torch.io.seqdb import write_cluster_db
        write_cluster_db(output + "_cluster", clusters)

    chkpnt.write_checkpoint(os.path.join(parent, "cluster.chk"), "1")
