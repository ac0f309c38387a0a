"""Cascaded clustering for large databases (linclust-style round 1).

Counterpart of unicore_tpu/align/cascade.py.  Single-round all-vs-all SW
is O(N^2); beyond a few thousand sequences the cascade bounds it to
O(N + R^2):

  1. greedy canopy assignment: sequences (longest first, in chunks) are
     matched against the current representative set with one
     (chunk, D) x (D, R) matrix product of hashed k-mer bags on the
     device; a sequence joins the best representative above the
     chance-corrected threshold, else it becomes a new representative
  2. verification: SW on the (member, representative) candidate pairs —
     O(N) pairs — keeps only members passing coverage/E-value
  3. representative merge: the normal prefilter + SW over the R
     representatives (R << N), gated on an empirical null of the round's
     own scores and merged transitively, joins clusters whose
     representatives are themselves homologous

Members of a merged representative follow it into the final cluster
(cascade semantics as in mmseqs cascaded clustering).

The canopy grams are float32 products of 0/1 bags (at most 2,048 set
bits), so every entry is an exact integer in float32 accumulation, TF32
included; they come back to the host as numpy float32, the type the JAX
function hands to the z-scores.  Only their padding to power-of-two
shapes (there for XLA's compile cache) is dropped.  The host logic is
numpy, as in the JAX package, and the alignments run on the port's
AlignmentEngine (the Hopper SW kernel on CUDA, its plain version on the
CPU).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from unicore_tpu_torch.align.prefilter import DEFAULT_DIM, featurize
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling


def _canopy_threshold(nrep: int) -> float:
    """Z-score an assignment must clear, as a function of the number of
    representatives it competes against.

    The chunk product takes a MAX over nrep chance overlaps; the expected
    maximum of nrep standard normals grows like sqrt(2 ln nrep), so a
    FIXED threshold drowns in chance matches once thousands of reps
    exist.  True same-family overlaps sit tens of sigma above chance, so
    the extreme-value guard costs no recall."""
    return 3.0 + float(np.sqrt(2.0 * np.log(max(nrep, 2))))


def _robust_null(shared: np.ndarray, exp: np.ndarray,
                 sample: int = 200_000) -> Tuple[float, float]:
    """Empirically calibrate the chance model of shared k-mer counts.

    Feature bags are correlated across sequences whenever an input
    channel has a skewed symbol distribution (3Di has a ~12% state), so
    the independent-hashing null is too optimistic.  Model:
    shared_null ~ alpha*exp + noise*sqrt(exp); alpha = median(shared/exp)
    and sigma = 1.4826*MAD of the normalized residual, both robust
    because true matches are a small minority of any chunk-vs-reps
    matrix at scale.  Returns (alpha, sigma)."""
    exp = np.maximum(exp, 1e-9)
    r = (shared / exp).ravel()
    if r.size > sample:
        r_s = r[:: max(1, r.size // sample)]
    else:
        r_s = r
    alpha = float(np.median(r_s))
    t = ((shared - alpha * exp) / np.sqrt(exp)).ravel()
    if t.size > sample:
        t = t[:: max(1, t.size // sample)]
    sigma = 1.4826 * float(np.median(np.abs(t - np.median(t))))
    return alpha, max(sigma, 1e-6)


def _gram(a: np.ndarray, b: np.ndarray, dev: torch.device) -> np.ndarray:
    """a @ b.T of two float32 0/1 bag matrices on `dev`, as numpy float32
    (exact integers: see the module docstring).  Counter `cascade.grams`."""
    profiling.add_counter("cascade.grams", 1)
    at = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bt = at if b is a else torch.from_numpy(np.ascontiguousarray(b)).to(dev)
    return torch.matmul(at, bt.T).cpu().numpy()


def canopy_assign(
    aa_seqs: List[str], ss_seqs: List[str],
    dim: int = DEFAULT_DIM, chunk: int = 2048,
    coverage: float = 0.8, device=None,
) -> Tuple[List[int], Dict[int, List[int]]]:
    """Greedy length-sorted canopy pass.

    Returns (representative indices, {rep: [candidate members]}).
    `device`: where the grams run (runtime/device.py decides when None).
    """
    dev = device_mod.resolve(device)
    N = len(aa_seqs)
    feats = featurize(aa_seqs, ss_seqs, dim=dim)
    kbits = feats.sum(axis=1)
    lens = np.array([len(s) for s in aa_seqs])
    order = np.argsort(-lens, kind="stable")

    reps: List[int] = []
    members: Dict[int, List[int]] = {}
    rep_feats: List[np.ndarray] = []
    calib = (1.0, 1.0)  # (alpha, sigma) of the empirical null

    for c0 in range(0, N, chunk):
        idxs = order[c0 : c0 + chunk]
        if reps:
            nrep = len(reps)
            shared = _gram(feats[idxs], np.stack(rep_feats), dev)
            expected = kbits[idxs][:, None] * kbits[reps][None, :] / dim
            alpha, sigma = calib = _robust_null(shared, expected)
            z = (shared - alpha * expected) / (np.sqrt(expected + 1.0) * sigma)
            # length-ratio bound implied by bidirectional coverage
            lr = (
                np.minimum(lens[idxs][:, None], lens[reps][None, :])
                / np.maximum(lens[idxs][:, None], lens[reps][None, :])
            )
            z = np.where(lr >= coverage, z, -np.inf)
            best = np.argmax(z, axis=1)
            ok = z[np.arange(len(idxs)), best] >= _canopy_threshold(nrep)
        else:
            ok = np.zeros(len(idxs), bool)
            best = np.zeros(len(idxs), int)

        # within-chunk pass: sequences may match representatives created
        # earlier in the same chunk (the cross-chunk product cannot see
        # them).  When many sequences remain unassigned, ALL chunk-internal
        # z-scores come from ONE gram up front (on the device from 256
        # sequences, numpy below) and the serial decision loop only
        # indexes into it; late chunks with few unassigned sequences keep
        # the cheap per-seq dots.
        n_un = int((~ok).sum())
        zmat = None
        if n_un >= 64:
            nloc = len(idxs)
            Fc = feats[idxs].astype(np.float32)
            Zc = _gram(Fc, Fc, dev) if nloc >= 256 else Fc @ Fc.T
            kb = kbits[idxs].astype(np.float64)
            exp_c = kb[:, None] * kb[None, :] / dim
            if not reps:
                # first chunk: calibrate the null on the chunk gram (the
                # diagonal self-matches are a sqrt(n) minority, far
                # inside the medians' breakdown point)
                calib = _robust_null(Zc, exp_c)
            alpha_c, sigma_c = calib
            zmat = (Zc - alpha_c * exp_c) / (np.sqrt(exp_c + 1.0) * sigma_c)
            lr_c = (
                np.minimum(lens[idxs][:, None], lens[idxs][None, :])
                / np.maximum(lens[idxs][:, None], lens[idxs][None, :])
            )
            zmat = np.where(lr_c >= coverage, zmat, -np.inf)

        local_reps: List[int] = []
        local_pos: List[int] = []  # chunk-local row of each local rep
        for ii, i in enumerate(idxs):
            if ok[ii]:
                members[reps[best[ii]]].append(int(i))
                continue
            assigned = False
            if local_reps:
                if zmat is not None:
                    z_l = zmat[ii, local_pos]
                else:
                    lr_feats = np.stack([feats[r] for r in local_reps])
                    shared_l = lr_feats @ feats[i]
                    expected_l = kbits[i] * kbits[local_reps] / dim
                    al, sg = calib
                    z_l = (shared_l - al * expected_l) / (
                        np.sqrt(expected_l + 1.0) * sg)
                    ratio = np.minimum(lens[i], lens[local_reps]) / np.maximum(
                        lens[i], lens[local_reps]
                    )
                    z_l = np.where(ratio >= coverage, z_l, -np.inf)
                bl = int(np.argmax(z_l))
                if z_l[bl] >= _canopy_threshold(len(reps) + len(local_reps)):
                    members[local_reps[bl]].append(int(i))
                    assigned = True
            if not assigned:
                reps.append(int(i))
                rep_feats.append(feats[i])
                members[int(i)] = []
                local_reps.append(int(i))
                local_pos.append(ii)
        msg.print_message(f"\rCanopy pass {min(c0 + chunk, N)}/{N} ({len(reps)} reps)...", 3)
    msg.println_message(" Done", 3)
    return reps, members


def build_verify_pairs(cand_members: Dict[int, List[int]]) -> List[Tuple[int, int]]:
    """Deterministic (member, rep) verification pair list (same order
    regardless of dict insertion history)."""
    return [(m, r) for r in sorted(cand_members) for m in sorted(cand_members[r])]


def verify_chunk(db, pairs: List[Tuple[int, int]], params) -> List[Tuple[int, int]]:
    """SW-verify a slice of (member, rep) pairs; returns the kept ones.

    Self-contained per call (fresh engine).  Only the sequences the
    chunk's pairs touch are encoded, but E-values are always computed
    against the FULL database size, so verification outcomes are
    invariant to how the pair list was chunked."""
    from unicore_tpu_torch.align.engine import AlignmentEngine, encode_db

    ids = sorted({i for p in pairs for i in p})
    local = {g: l for l, g in enumerate(ids)}
    q_aa, q_ss = encode_db(
        [db.aa_seqs[i] for i in ids], [db.ss_seqs[i] for i in ids]
    )
    engine = AlignmentEngine(params)
    qlen = np.array([len(a) for a in q_aa])
    lpairs = [(local[m], local[r]) for m, r in pairs]
    hits = engine.align_pairs(
        q_aa, q_ss, q_aa, q_ss, lpairs,
        n_db=float(sum(len(s) for s in db.aa_seqs)), n_seqs=len(db),
    )
    kept = {(h.qidx, h.tidx) for h in engine.gate(hits, qlen, qlen)}
    return [p for p, lp in zip(pairs, lpairs) if lp in kept]


def apply_verification(
    reps: List[int], cand_members: Dict[int, List[int]], kept: set
) -> Dict[int, List[int]]:
    """Fold kept (member, rep) pairs back into per-rep member lists;
    unverified members become their own singleton reps (mutates `reps`)."""
    verified: Dict[int, List[int]] = {r: [] for r in reps}
    unassigned: List[int] = []
    for m, r in build_verify_pairs(cand_members):
        if (m, r) in kept:
            verified[r].append(m)
        else:
            unassigned.append(m)
    for m in unassigned:
        verified.setdefault(m, [])
        if m not in reps:
            reps.append(m)
    return verified


# Empirical pair-E threshold for representative-merge edges (the JAX
# package's value, mid-plateau of its purity sweep).
REP_PAIR_E = 1e-5


def representative_round(
    db, reps: List[int], verified: Dict[int, List[int]], params
) -> Tuple[Dict[int, List[int]], list]:
    """Prefilter + SW + transitive merge over the representatives, then
    members follow their representative into the final clusters.

    Two policies differ from the direct (<= cascade threshold) path:

    * **Empirical edge null.**  The rep round aligns an overwhelmingly
      chance population, on which the simulated model null is
      tail-optimistic; the forward scores of the round ARE a null sample,
      so the gate fits per-length Gumbel quantiles on them
      (stats.fit_empirical_pair_null) and additionally requires
      pair-E <= REP_PAIR_E.  Small rounds (< 5000 pairs) skip the fit
      (model gate only).
    * **Transitive (connected-component) merging**, matching cascaded-
      clustering semantics; the direct path keeps greedy set cover.

    Counters: `cascade.rep_pairs` (candidate pairs aligned),
    `cascade.rep_edges` (gated edges) and `cascade.empirical_null_fitted`
    (1 when the round's null was fitted)."""
    from unicore_tpu_torch.align import stats
    from unicore_tpu_torch.align.engine import AlignmentEngine, encode_db
    from unicore_tpu_torch.align.prefilter import candidate_pairs

    engine = AlignmentEngine(params)
    rep_aa = [db.aa_seqs[r] for r in reps]
    rep_ss = [db.ss_seqs[r] for r in reps]
    rpairs = candidate_pairs(
        rep_aa, rep_ss,
        min_shared=params.min_shared_kmers,
        coverage=params.coverage if params.cov_mode == 0 else 0.0,
        sens=params.sens, max_seqs=params.max_seqs,
    )
    r_aa, r_ss = encode_db(rep_aa, rep_ss)
    profiling.add_counter("cascade.rep_pairs", len(rpairs))
    profiling.add_counter("cascade.empirical_null_fitted", 0)

    def edge_null_filter(best, qlen_pairs, tlen_pairs, live):
        null = stats.fit_empirical_pair_null(
            best[live], qlen_pairs[live], tlen_pairs[live])
        if null is None:
            return np.ones(len(best), bool)
        profiling.add_counter("cascade.empirical_null_fitted", 1)
        logE = null.pair_logE(best, qlen_pairs, tlen_pairs)
        msg.println_message(
            f"Rep round: empirical null on {int(live.sum())} pairs, "
            f"{int((logE <= np.log(REP_PAIR_E)).sum())} pass pair-E", 4)
        return logE <= np.log(REP_PAIR_E)

    # E-values against the FULL database, not the rep subset (the rep
    # round continues clustering the same database)
    rhits = engine.align_pairs(
        r_aa, r_ss, r_aa, r_ss, rpairs,
        n_db=float(sum(len(s) for s in db.aa_seqs)), n_seqs=len(db),
        score_filter=edge_null_filter,
    )
    rlen = np.array([len(a) for a in r_aa])
    rkept = engine.gate(rhits, rlen, rlen)
    profiling.add_counter("cascade.rep_edges", len(rkept))

    # transitive merge: union-find over gated edges
    parent = list(range(len(reps)))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for h in rkept:
        ra, rb = find(h.qidx), find(h.tidx)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)  # deterministic: min wins

    comps: Dict[int, List[int]] = {}
    for i in range(len(reps)):
        comps.setdefault(find(i), []).append(i)

    final: Dict[int, List[int]] = {}
    for rrep_local, rmembers_local in comps.items():
        root = reps[rrep_local]
        out = []
        for rl in rmembers_local:
            r_global = reps[rl]
            out.append(r_global)
            out.extend(verified.get(r_global, []))
        final[root] = sorted(set(out))
    return final, rkept


def cascaded_cluster(db, params) -> Tuple[Dict[int, List[int]], list]:
    """Full cascade; returns ({rep: members}, rep-level hits).

    Counters: `cascade.reps` (canopy representatives),
    `cascade.verify_pairs` and `cascade.verified` (member pairs aligned
    and kept), then those of representative_round."""
    n = len(db)
    reps, cand_members = canopy_assign(db.aa_seqs, db.ss_seqs, coverage=params.coverage)
    msg.println_message(f"Cascade: {len(reps)} canopy representatives for {n} sequences", 3)

    pairs = build_verify_pairs(cand_members)
    kept = set(verify_chunk(db, pairs, params)) if pairs else set()
    profiling.add_counter("cascade.reps", len(reps))
    profiling.add_counter("cascade.verify_pairs", len(pairs))
    profiling.add_counter("cascade.verified", len(kept))
    verified = apply_verification(reps, cand_members, kept)
    return representative_round(db, reps, verified, params)
