"""Pairwise alignment engine — batched all-vs-all orchestration.

Counterpart of unicore_tpu/align/engine.py, on PyTorch.  Stages:

  1. prefilter: hashed k-mer bag matmul (align/prefilter.py) -> candidate
     pairs (plus a length-ratio bound implied by the coverage threshold)
  2. ungapped rescore, then the forward SW, pairs packed into (Lq, Lt)
     length buckets -> score + end cell per pair
  3. reverse SW on the reversed prefixes ending at the end cell -> start
     cell (classic two-pass trick: no traceback storage for the bulk)
  4. coverage / E-value gating, with statistics fitted by simulating the
     same forward pass (align/stats.py)

Every full-matrix pass (rescore, forward, reverse and the calibration)
goes through `_forward_batch`, which calls the Hopper kernel's wrapper
(ops/sw_cuda.py): on a CUDA device it launches the kernel, on the CPU it
runs the kernel's plain version.  Pairs longer than `long_threshold` take
banded SW the same way, through the banded kernel's wrapper
(ops/banded_cuda.py, plain version in ops/banded.py).

`traceback_fill` (the m8 columns of `search`, and `--min-seq-id > 0`)
runs its short windows' forward DPs on the engine's device through
ops/sw_bits.py and its long windows on the host.

Where parallel.mesh.local_mesh gives a mesh (several cards), the
full-matrix and banded batches are padded to a multiple of the shards
and run data-parallel over them (`sw_forward_sharded`,
`sw_forward_banded_sharded`), as the JAX engine's multi-device branches
do; the substitution matrices are copied to each card once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unicore_tpu_torch.alphabets import encode_3di, encode_aa
from unicore_tpu_torch.align import stats
from unicore_tpu_torch.matrices import W_3DI, W_AA, get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling


@dataclass
class AlignParams:
    # integer scoring units (see ops/sw.py): foldseek's mean-combined
    # scoring (0.4 aa + 0.6 3di, gap 10/1) scaled x10 to integers
    # (4, 6, 100, 10)
    gap_open: float = 100.0
    gap_extend: float = 10.0
    w_aa: float = W_AA
    w_3di: float = W_3DI
    coverage: float = 0.8
    cov_mode: int = 0
    evalue: float = 1e-3
    min_seq_id: float = 0.0
    min_shared_kmers: int = 2
    batch_size: int = 512  # pairs per device batch
    # ungapped diagonal rescore gate between the k-mer prefilter and
    # gapped SW (foldseek's rescore stage, cluster.rs:43-55 pipeline).
    # Internal scoring units (~2.857x foldseek's); 40 =~ foldseek 14.
    # The stage only prunes pairs whose best gap-free segment scores
    # below this — calibrated so no pair that would survive the final
    # coverage/E-value gates is lost (tests/test_align_engine.py).
    min_ungapped_score: float = 40.0
    # prefilter caps (foldseek analogs): max candidate targets per query
    # (--max-seqs) and sensitivity -s mapped onto the chance-excess
    # threshold of the hashed k-mer bag (higher s => more permissive)
    max_seqs: int = 1000
    sens: float = 5.7
    # target-side gap runs are capped at this length in BOTH backends
    # (identical windowed-gap algorithm on TPU and CPU, so outputs stay
    # byte-identical across backends).  A 64-gap costs 100+63*10 = 730
    # internal units — beyond any alignment that passes the default
    # coverage gate; exactness vs full Gotoh is asserted on every tested
    # distribution (tests/test_sw.py).  0 = unbounded (full scan).
    gap_window: int = 64
    # pairs longer than this run BANDED SW (ops/banded.py): a host k-mer
    # diagonal vote seeds a width-`band_width` band, making long pairs
    # O(L*W) instead of O(L^2) — the foldseek k-mer-diagonal -> banded
    # alignment design (cluster.rs:43-55 contract).  Exact whenever the
    # optimum stays inside the band; the same banded code runs on both
    # backends (byte-identity contract, like gap_window).
    long_threshold: int = 1024
    band_width: int = 256
    # local composition-bias score correction (align/bias.py), foldseek's
    # default-on `--comp-bias-corr 1` (cluster.rs:43-55 contract): damps
    # spurious scores between composition-biased / low-complexity
    # sequences.  Applied identically in every scoring path (rescore,
    # forward, reverse, banded, traceback) AND in the E-value
    # calibration, so statistics stay consistent.
    comp_bias_corr: int = 1

    @classmethod
    def from_options(cls, options: str) -> "AlignParams":
        """Parse the foldseek-style option string (e.g. "-c 0.8")."""
        p = cls()
        toks = (options or "").split()
        i = 0
        while i < len(toks):
            t = toks[i]

            def val() -> str:
                nonlocal i
                i += 1
                return toks[i]

            if t == "-c":
                p.coverage = float(val())
            elif t == "--cov-mode":
                p.cov_mode = int(val())
            elif t == "-e":
                p.evalue = float(val())
            elif t == "--min-seq-id":
                p.min_seq_id = float(val())
            elif t == "--gap-open":
                # user options use foldseek units (mean-combined scale);
                # internal integer units are x10 (weights 4/6 vs 0.4/0.6)
                p.gap_open = round(float(val()) * 10)
            elif t == "--gap-extend":
                p.gap_extend = round(float(val()) * 10)
            elif t == "--min-ungapped-score":
                p.min_ungapped_score = round(float(val()) * 10)
            elif t == "--max-seqs":
                p.max_seqs = int(val())
            elif t == "--band-width":
                p.band_width = int(val())
            elif t == "--comp-bias-corr":
                p.comp_bias_corr = int(val())
            elif t == "--long-threshold":
                p.long_threshold = int(val())
            elif t == "-s":
                p.sens = float(val())
            elif t in ("--threads", "-v"):
                val()  # accepted, handled elsewhere
            i += 1
        return p


@dataclass
class Hit:
    qidx: int
    tidx: int
    score: float
    qstart: int  # 0-based inclusive
    qend: int
    tstart: int
    tend: int
    evalue: float = 0.0
    bits: float = 0.0
    fident: float = 0.0
    alnlen: int = 0
    mismatch: int = 0
    gapopen: int = 0


# the plain banded row loop's (B, LQ, W) float32 band: its batches stay
# under this many bytes
PLAIN_BAND_BYTES = 128 * 2**20


def banded_batch_size(batch_size: int, LQ: int, W: int, kernel_route: bool) -> int:
    """Pairs per banded batch of a (LQ, ., W) bucket.  The kernel route (a
    CUDA device, no mesh) holds no band per pair, so it takes the engine's
    `batch_size`; the plain row loop (the CPU) and the sharded route build
    the (B, LQ, W) band and stay under PLAIN_BAND_BYTES, 8 pairs at least."""
    if kernel_route:
        return batch_size
    return min(batch_size, max(8, PLAIN_BAND_BYTES // (LQ * W * 4)))


def _bucket(n: int, minimum: int = 128) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class AlignmentEngine:
    """Batched SW scoring over candidate pairs.

    `device`: where the DPs run (runtime/device.py decides when None).
    `saa` / `s3d`: substitution matrices; None = the defaults of
    matrices.py (convert.from_jax_arrays hands over a JAX engine's)."""

    name = "torch-align"

    def __init__(self, params: Optional[AlignParams] = None, device=None,
                 saa: Optional[np.ndarray] = None, s3d: Optional[np.ndarray] = None):
        self.params = params or AlignParams()
        self.device = device_mod.resolve(device)
        self.saa = (get_aa_matrix() if saa is None else np.asarray(saa)).astype(np.float32)
        self.s3d = (get_3di_matrix() if s3d is None else np.asarray(s3d)).astype(np.float32)
        # integer-valued matrices: the JAX engine's exactness contract,
        # kept so both engines accept the same inputs
        for m in (self.saa, self.s3d):
            if not np.array_equal(m, np.round(m)):
                raise ValueError("substitution matrices must be integer-valued "
                                 "(bf16/int16 exactness contract, ops/sw.py)")
        self._saa_t = torch.from_numpy(self.saa).to(self.device)
        self._s3d_t = torch.from_numpy(self.s3d).to(self.device)
        # one copy per device of a mesh, made at its first sharded batch
        self._saa_r = mesh_mod.Replicas(self._saa_t)
        self._s3d_r = mesh_mod.Replicas(self._s3d_t)
        self._lambda = stats.combined_lambda(
            self.saa[:20, :20], self.s3d[:20, :20], self.params.w_aa, self.params.w_3di
        )
        self._gapped: Optional["stats.GappedStats"] = None

    # ------------------------------------------------------------------
    def _stats(self) -> "stats.GappedStats":
        """Calibrated gapped statistics (lambda, K, edge-effect length):
        fitted by simulating the forward pass on random pairs at several
        lengths, disk-cached per scoring config in the port's own cache
        directory (align/stats.py)."""
        if self._gapped is None:
            import hashlib
            p = self.params
            from unicore_tpu_torch.matrices import get_3di_background
            keysrc = (
                self.saa.tobytes() + self.s3d.tobytes()
                + get_3di_background().tobytes()
                + np.array([p.w_aa, p.w_3di, p.gap_open, p.gap_extend,
                            float(p.gap_window),
                            float(p.comp_bias_corr)]).tobytes()
            )
            key = hashlib.md5(keysrc).hexdigest()[:16]

            def score_fn(qa, qs, ta, ts, ql, tl):
                # the null-model simulation goes through _forward_batch,
                # which applies the same composition-bias correction as
                # production scoring — calibrated statistics match the
                # corrected score distribution
                b, _, _ = self._forward_batch(qa, qs, ta, ts, ql, tl)
                return _to_host(b)

            self._gapped = stats.calibrate_gapped_lengths(score_fn, key)
        return self._gapped

    # ------------------------------------------------------------------
    def _forward_batch(
        self,
        qa: np.ndarray, qs: np.ndarray, ta: np.ndarray, ts: np.ndarray,
        qlen: np.ndarray, tlen: np.ndarray,
        ungapped: bool = False,
        qc: Optional[np.ndarray] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B,) best / qend / tend for one padded batch, as tensors on the
        engine's device (not yet synchronised: callers collect after
        dispatching all batches).

        `qc`: (B, Lq) int32 per-query-position composition-bias
        corrections.  None with comp_bias_corr on = compute here from
        the batch codes (the calibration path); callers that already
        hold per-sequence corrections pass the packed slice."""
        from unicore_tpu_torch.ops.sw_cuda import sw_forward_cuda

        p = self.params
        if qc is None and p.comp_bias_corr:
            from unicore_tpu_torch.align.bias import composition_bias
            qc = composition_bias(qa, qs, qlen, self.saa, self.s3d,
                                  p.w_aa, p.w_3di)
        dev = self.device
        mesh = mesh_mod.local_mesh(dev)
        if mesh is not None:
            # several devices: pad the batch to a multiple of devices x 16
            # (code 20, length 1, zero bias), never fall back to one device
            # for a tail batch, and slice the pad rows off again
            from unicore_tpu_torch.ops.sw_cuda import sw_forward_sharded

            B0 = qa.shape[0]
            B = _round_up(B0, mesh_mod.n_shards(mesh) * 16)
            pad = mesh_mod.pad_rows
            best, qe, te = sw_forward_sharded(
                pad(qa, B, 20), pad(qs, B, 20), pad(ta, B, 20), pad(ts, B, 20),
                pad(qlen, B, 1), pad(tlen, B, 1), self._saa_r, self._s3d_r, mesh,
                go=p.gap_open, ge=p.gap_extend, w_aa=p.w_aa, w_3di=p.w_3di,
                ungapped=ungapped, gap_window=p.gap_window,
                qc=None if qc is None else pad(qc, B, 0),
            )
            return best[:B0], qe[:B0], te[:B0]
        return sw_forward_cuda(
            _as_i32(qa, dev), _as_i32(qs, dev), _as_i32(ta, dev), _as_i32(ts, dev),
            _as_i32(qlen, dev), _as_i32(tlen, dev), self._saa_t, self._s3d_t,
            go=p.gap_open, ge=p.gap_extend, w_aa=p.w_aa, w_3di=p.w_3di,
            gap_window=p.gap_window, ungapped=ungapped,
            qc=None if qc is None else _as_i32(qc, dev),
        )

    # ------------------------------------------------------------------
    def _sw_pass(
        self, entries: List[tuple], ungapped: bool = False,
        counter: str = "align", split_long: bool = True,
    ) -> Dict[int, Tuple[float, int, int]]:
        """Bucketed, padded, batched kernel dispatch.

        `entries` is a list of (key, qa, qs, ta, ts[, qc]) per pair
        (code arrays, unpadded; qc = optional per-query-position
        composition-bias corrections, same length as qa).  Returns
        {key: (best, qend, tend)}.  All batches are dispatched before
        any result is collected, so host packing overlaps device
        compute.  `split_long=False` forces the full-matrix path even
        above `long_threshold` (the banded pass's last-resort fallback
        for seedless pairs).
        """
        p = self.params
        from unicore_tpu_torch.runtime import profiling
        t0 = __import__("time").time()
        entries = [e if len(e) == 6 else (*e, None) for e in entries]
        if p.comp_bias_corr:
            # entries without a caller-supplied correction (callers that
            # pre-compute per-unique-sequence, like align_pairs, pass
            # slices) get one computed here, so every scoring path is
            # bias-corrected exactly once
            from unicore_tpu_torch.align.bias import composition_bias
            entries = [
                e if e[5] is not None else (*e[:5], composition_bias(
                    np.asarray(e[1])[None, :], np.asarray(e[2])[None, :],
                    np.array([len(e[1])]), self.saa, self.s3d,
                    p.w_aa, p.w_3di)[0])
                for e in entries
            ]
        buckets: Dict[Tuple[int, int], List[tuple]] = {}
        long_entries: List[tuple] = []
        for e in entries:
            n = max(len(e[1]), len(e[3]))
            if split_long and p.long_threshold and n > p.long_threshold:
                long_entries.append(e)
                continue
            b = _bucket(n)
            buckets.setdefault((b, b), []).append(e)
        inflight = []
        for (LQ, LT), items in sorted(buckets.items()):
            for s0 in range(0, len(items), p.batch_size):
                chunk = items[s0 : s0 + p.batch_size]
                # fixed batch shape whenever the bucket spans multiple
                # chunks; single-chunk buckets pad to a power-of-two
                # class (the JAX engine's batch shapes, kept so both
                # engines count the same cells)
                B = p.batch_size if len(items) > p.batch_size else min(
                    p.batch_size, max(16, 1 << (len(chunk) - 1).bit_length())
                )
                qa = np.full((B, LQ), 20, dtype=np.int32)
                qs = np.full((B, LQ), 20, dtype=np.int32)
                ta = np.full((B, LT), 20, dtype=np.int32)
                ts = np.full((B, LT), 20, dtype=np.int32)
                ql = np.ones(B, dtype=np.int32)
                tl = np.ones(B, dtype=np.int32)
                qcb = (np.zeros((B, LQ), np.int32)
                       if any(e[5] is not None for e in chunk) else None)
                for row, (_, eqa, eqs, eta, ets, eqc) in enumerate(chunk):
                    ql[row] = len(eqa)
                    tl[row] = len(eta)
                    qa[row, : ql[row]] = eqa
                    qs[row, : ql[row]] = eqs
                    ta[row, : tl[row]] = eta
                    ts[row, : tl[row]] = ets
                    if qcb is not None and eqc is not None:
                        qcb[row, : ql[row]] = eqc
                inflight.append(
                    (chunk, self._forward_batch(qa, qs, ta, ts, ql, tl,
                                                ungapped=ungapped, qc=qcb))
                )
                profiling.add_counter(f"{counter}.cells", float(B) * LQ * LT)
        out: Dict[int, Tuple[float, int, int]] = {}
        if long_entries:
            out.update(self._banded_pass(long_entries, ungapped=ungapped, counter=counter))
        for chunk, res in inflight:
            b, qe, te = (_to_host(x) for x in res)
            for row, e in enumerate(chunk):
                out[e[0]] = (float(b[row]), int(qe[row]), int(te[row]))
        profiling.add_counter(f"{counter}.seconds", __import__("time").time() - t0)
        return out

    # ------------------------------------------------------------------
    def _banded_buckets(self, entries: List[tuple]) -> Tuple[
        Dict[Tuple[int, int, int], List[tuple]], List[tuple], List[int]
    ]:
        """The banded pass's seeding: each pair's seed diagonal and band
        width, by (LQ, LT, W) bucket.  Returns (buckets {(LQ, LT, W):
        [(key, qa, qs, ta, ts, qc, d0)]}, the pairs for full SW, the keys
        that score 0)."""
        from unicore_tpu_torch.ops.banded import vote_diagonal

        p = self.params
        buckets: Dict[Tuple[int, int, int], List[tuple]] = {}
        full_fallback: List[tuple] = []
        unseeded: List[int] = []
        entries = [e if len(e) == 6 else (*e, None) for e in entries]
        for key, eqa, eqs, eta, ets, eqc in entries:
            d0 = vote_diagonal(eqa, eqs, eta, ets)
            wide = 0
            if d0 is None:
                # recall-cliff fallback: distant homologs with zero exact
                # combined 6-mers get a more sensitive seed (3Di-only,
                # then reduced-alphabet AA) and a doubled band;
                # still-seedless pairs go to full (unbanded) SW rather
                # than scoring 0.
                from unicore_tpu_torch.ops.banded import (
                    has_seed_evidence, vote_diagonal_sensitive,
                )
                d0 = vote_diagonal_sensitive(eqa, eqs, eta, ets)
                if d0 is None:
                    # full SW only with chance-corrected seed evidence;
                    # chance-level pairs score 0 (foldseek's prefilter
                    # would never let them through to alignment)
                    if has_seed_evidence(eqa, eqs, eta, ets):
                        full_fallback.append((key, eqa, eqs, eta, ets, eqc))
                    else:
                        unseeded.append(key)
                    continue
                wide = 1
            LQ = _bucket(len(eqa))
            LT = _bucket(len(eta))
            W = max(p.band_width << wide,
                    _round_up(abs(len(eqa) - len(eta)) + 128, 128))
            W = min(W, LT)  # a band wider than the target is the full matrix
            buckets.setdefault((LQ, LT, W), []).append((key, eqa, eqs, eta, ets, eqc, d0))
        return buckets, full_fallback, unseeded

    def _banded_pass(
        self, entries: List[tuple], ungapped: bool = False,
        counter: str = "align",
    ) -> Dict[int, Tuple[float, int, int]]:
        """Banded SW for long pairs (ops/banded.py).

        Host k-mer diagonal vote -> width-W band around the seed diagonal
        -> device band scan, O(Lq*W) per pair.  Pairs with zero k-mer
        matches score 0 (nothing a 6-mer-free pair could contribute past
        the gates).  Same dispatch-then-collect overlap as _sw_pass.

        Counters: `banded.seconds` is the pass's host wall, split into
        `banded.seed.seconds` (the diagonal votes and the seed-evidence
        gate), `banded.pack.seconds` (padding and the copies to the device)
        and `banded.device.seconds` (the full-SW fallback, dispatch and
        collection); `banded.launches` counts the batches dispatched,
        `banded.pairs` the seeded pairs they carry (padding not counted)
        and `banded.buckets` their (LQ, LT, W) buckets."""
        from unicore_tpu_torch.ops.banded import sw_forward_banded_sharded
        from unicore_tpu_torch.ops.banded_cuda import sw_forward_banded_cuda
        from unicore_tpu_torch.runtime import profiling

        p = self.params
        dev = self.device
        mesh = mesh_mod.local_mesh(dev)
        t0 = time.time()
        split = {"seed": 0.0, "pack": 0.0, "device": 0.0}
        lap = [t0]

        def charge(part: str) -> None:
            """Add the time since the last charge to `part`."""
            now = time.time()
            split[part] += now - lap[0]
            lap[0] = now

        buckets, full_fallback, unseeded = self._banded_buckets(entries)
        out: Dict[int, Tuple[float, int, int]] = {key: (0.0, 0, 0) for key in unseeded}
        charge("seed")
        if full_fallback:
            out.update(self._sw_pass(
                full_fallback, ungapped=ungapped, counter=counter,
                split_long=False,
            ))
        charge("device")
        inflight = []
        kernel_route = mesh is None and torch.device(dev).type == "cuda"
        profiling.add_counter("banded.buckets", float(len(buckets)))
        for (LQ, LT, W), items in sorted(buckets.items()):
            bsz = banded_batch_size(p.batch_size, LQ, W, kernel_route)
            profiling.add_counter("banded.pairs", float(len(items)))
            for s0 in range(0, len(items), bsz):
                chunk = items[s0 : s0 + bsz]
                # pow2 batch classes for single-chunk buckets (the JAX
                # engine's batch shapes)
                B = bsz if len(items) > bsz else min(
                    bsz, max(8, 1 << (len(chunk) - 1).bit_length())
                )
                qa = np.full((B, LQ), 20, dtype=np.int32)
                qs = np.full((B, LQ), 20, dtype=np.int32)
                ta = np.full((B, LT), 20, dtype=np.int32)
                ts = np.full((B, LT), 20, dtype=np.int32)
                ql = np.ones(B, dtype=np.int32)
                tl = np.ones(B, dtype=np.int32)
                d0 = np.zeros(B, dtype=np.int32)
                qcb = (np.zeros((B, LQ), np.int32)
                       if any(e[5] is not None for e in chunk) else None)
                for row, (_, eqa, eqs, eta, ets, eqc, ed) in enumerate(chunk):
                    ql[row] = len(eqa)
                    tl[row] = len(eta)
                    qa[row, : ql[row]] = eqa
                    qs[row, : ql[row]] = eqs
                    ta[row, : tl[row]] = eta
                    ts[row, : tl[row]] = ets
                    d0[row] = ed
                    if qcb is not None and eqc is not None:
                        qcb[row, : ql[row]] = eqc
                kw = dict(W=W, go=p.gap_open, ge=p.gap_extend, w_aa=p.w_aa, w_3di=p.w_3di,
                          gap_window=p.gap_window, ungapped=ungapped)
                if mesh is not None:
                    # several devices: pad to a multiple of them (d0 = 0 on
                    # pad rows), as _forward_batch does; the shards' copies
                    # are made inside the call
                    Bd = _round_up(B, mesh_mod.n_shards(mesh))
                    pad = mesh_mod.pad_rows
                    arrays = [pad(x, Bd, v) for x, v in ((qa, 20), (qs, 20), (ta, 20), (ts, 20),
                                                         (ql, 1), (tl, 1), (d0, 0))]
                    qcp = None if qcb is None else pad(qcb, Bd, 0)
                    charge("pack")
                    res = sw_forward_banded_sharded(*arrays, self._saa_r, self._s3d_r, mesh,
                                                    qc=qcp, **kw)
                else:
                    arrays = [_as_i32(x, dev) for x in (qa, qs, ta, ts, ql, tl, d0)]
                    qct = None if qcb is None else _as_i32(qcb, dev)
                    charge("pack")
                    res = sw_forward_banded_cuda(*arrays, self._saa_t, self._s3d_t, qc=qct, **kw)
                inflight.append((chunk, res))
                profiling.add_counter(f"{counter}.cells", float(B) * LQ * W)
                profiling.add_counter("banded.launches", 1.0)
                charge("device")
        for chunk, res in inflight:
            b, qe, te = (_to_host(x) for x in res)
            for row, e in enumerate(chunk):
                out[e[0]] = (float(b[row]), int(qe[row]), int(te[row]))
        charge("device")
        # host wall time, seeding and collection included (a share of
        # {counter}.seconds); the three parts sum to it
        for part, sec in split.items():
            profiling.add_counter(f"banded.{part}.seconds", sec)
        profiling.add_counter("banded.seconds", lap[0] - t0)
        return out

    # ------------------------------------------------------------------
    def align_pairs(
        self,
        q_aa: Sequence[np.ndarray], q_ss: Sequence[np.ndarray],
        t_aa: Sequence[np.ndarray], t_ss: Sequence[np.ndarray],
        pairs: Sequence[Tuple[int, int]],
        n_db: Optional[float] = None,
        n_seqs: Optional[int] = None,
        score_filter=None,
    ) -> List[Hit]:
        """Forward+reverse SW for every (qidx, tidx) pair; returns raw hits
        with score and start/end coordinates (no gating).

        `n_db` / `n_seqs` override the E-value database size; callers
        that align a SUBSET of a database (chunked verification) must
        pass the full-database totals so E-values are invariant to how
        the work was chunked.

        `score_filter(best, qlen_pairs, tlen_pairs, live)` — optional
        callback invoked once after the forward pass with the per-pair
        best scores, pair lengths, and the liveness mask; returns a
        boolean keep-mask folded into the skip set before the reverse
        pass.  Lets a caller that aligns a chance-dominated population
        (the cascade's representative round) fit an EMPIRICAL null on
        the observed batch and gate on it — at zero extra kernel cost
        (align/cascade.py, stats.fit_empirical_pair_null)."""
        if not pairs:
            return []
        p = self.params

        qlen_all = np.array([len(a) for a in q_aa])
        tlen_all = np.array([len(a) for a in t_aa])

        # per-unique-query composition-bias corrections, computed once
        # and sliced into every pass (forward, rescore, reverse) so all
        # scoring of a pair uses identical per-position values
        _qc_cache: Dict[int, np.ndarray] = {}

        def qbias(qi: int):
            if not p.comp_bias_corr:
                return None
            if qi not in _qc_cache:
                from unicore_tpu_torch.align.bias import composition_bias
                _qc_cache[qi] = composition_bias(
                    np.asarray(q_aa[qi])[None, :], np.asarray(q_ss[qi])[None, :],
                    np.array([len(q_aa[qi])]), self.saa, self.s3d,
                    p.w_aa, p.w_3di,
                )[0]
            return _qc_cache[qi]

        # ---- ungapped diagonal rescore gate (foldseek rescore analog) ----
        # The per-row cost of the diagonal chain is ~10x cheaper than
        # gapped SW, so pruning here directly saves SW wall-clock.
        live = list(range(len(pairs)))
        if p.min_ungapped_score > 0:
            entries = [
                (k, q_aa[qi], q_ss[qi], t_aa[ti], t_ss[ti], qbias(qi))
                for k, (qi, ti) in enumerate(pairs)
            ]
            diag = self._sw_pass(entries, ungapped=True, counter="rescore")
            live = [k for k in live if diag[k][0] >= p.min_ungapped_score]
            from unicore_tpu_torch.runtime import profiling
            profiling.add_counter("rescore.kept", len(live))
            msg.print_message(
                f" [rescore kept {len(live)}/{len(pairs)}]", 4)

        best = np.zeros(len(pairs))
        qend = np.zeros(len(pairs), dtype=np.int64)
        tend = np.zeros(len(pairs), dtype=np.int64)
        pruned = np.ones(len(pairs), dtype=bool)
        pruned[live] = False

        fwd = self._sw_pass(
            [(k, q_aa[pairs[k][0]], q_ss[pairs[k][0]],
              t_aa[pairs[k][1]], t_ss[pairs[k][1]], qbias(pairs[k][0]))
             for k in live],
            counter="align",
        )
        for k, (b, qe, te) in fwd.items():
            best[k] = b
            qend[k] = qe
            tend[k] = te

        # ---- reverse pass for starts ----
        # exact pre-filters: an alignment ending at (qend, tend) can cover
        # >= c of the query only if qend+1 >= c*qlen (any start); same for
        # the target side.  Pairs that already fail these (or the E-value
        # gate on the final score) never need the reverse pass.
        if n_db is None:
            n_db = float(tlen_all.sum())
        if n_seqs is None:
            n_seqs = int(len(tlen_all))
        gs = self._stats()
        skip = pruned.copy()
        if score_filter is not None:
            qlen_pairs = np.array([qlen_all[qi] for qi, _ in pairs])
            tlen_pairs = np.array([tlen_all[ti] for _, ti in pairs])
            keep = np.asarray(
                score_filter(best, qlen_pairs, tlen_pairs, ~skip), bool)
            skip |= ~keep
        cov = p.coverage
        for k, (qi, ti) in enumerate(pairs):
            if skip[k]:
                continue
            if best[k] <= 0:
                skip[k] = True
                continue
            if p.cov_mode in (0, 2) and (qend[k] + 1) < cov * qlen_all[qi]:
                skip[k] = True
                continue
            if p.cov_mode in (0, 1) and (tend[k] + 1) < cov * tlen_all[ti]:
                skip[k] = True
                continue
            if float(gs.evalue(best[k], qlen_all[qi], n_db, n_seqs)) > p.evalue:
                skip[k] = True

        starts_q = np.zeros(len(pairs), dtype=np.int64)
        starts_t = np.zeros(len(pairs), dtype=np.int64)
        rev_entries = []
        for k, (qi, ti) in enumerate(pairs):
            if skip[k]:
                continue
            nq, nt = qend[k] + 1, tend[k] + 1
            # the reverse pass reuses the FORWARD per-position bias values
            # (sliced + reversed) rather than recomputing on the truncated
            # sequence: every cell then scores identically in both passes,
            # so the reverse end is exactly the forward optimum's start
            qc_full = qbias(qi)
            rev_entries.append((
                k,
                q_aa[qi][:nq][::-1], q_ss[qi][:nq][::-1],
                t_aa[ti][:nt][::-1], t_ss[ti][:nt][::-1],
                None if qc_full is None else qc_full[:nq][::-1],
            ))
        rev = self._sw_pass(rev_entries, counter="align")
        for k, (_, qe, te) in rev.items():
            starts_q[k] = qend[k] - qe
            starts_t[k] = tend[k] - te

        hits = []
        for k, (qi, ti) in enumerate(pairs):
            if skip[k]:
                continue
            ev = float(gs.evalue(best[k], qlen_all[qi], n_db, n_seqs))
            bits = float(gs.bits(best[k]))
            hits.append(
                Hit(
                    qidx=int(qi), tidx=int(ti), score=float(best[k]),
                    qstart=int(starts_q[k]), qend=int(qend[k]),
                    tstart=int(starts_t[k]), tend=int(tend[k]),
                    evalue=ev, bits=bits,
                )
            )
        return hits

    # ------------------------------------------------------------------
    def gate(self, hits: List[Hit], qlen: np.ndarray, tlen: np.ndarray) -> List[Hit]:
        """Coverage + E-value gating (cov-mode 0/1/2 as mmseqs)."""
        p = self.params
        out = []
        for h in hits:
            qcov = (h.qend - h.qstart + 1) / qlen[h.qidx]
            tcov = (h.tend - h.tstart + 1) / tlen[h.tidx]
            if p.cov_mode == 0:
                ok = qcov >= p.coverage and tcov >= p.coverage
            elif p.cov_mode == 1:
                ok = tcov >= p.coverage
            elif p.cov_mode == 2:
                ok = qcov >= p.coverage
            else:
                ok = True
            if ok and h.evalue <= p.evalue:
                out.append(h)
        return out

    # ------------------------------------------------------------------
    def traceback_fill(
        self,
        hits: List[Hit],
        q_aa: Sequence[np.ndarray], q_ss: Sequence[np.ndarray],
        t_aa: Sequence[np.ndarray], t_ss: Sequence[np.ndarray],
    ) -> None:
        """Exact traceback on the aligned windows; fills m8 columns in place.

        Short windows (<= long_threshold) batch their forward DPs into
        device dispatches on the engine's device (ops/sw_bits.py:
        direction bits + O(path) host decode, bit-identical to the NumPy
        Gotoh); long windows take the banded host traceback per hit,
        seeded by vote_diagonal or, failing that, vote_diagonal_sensitive
        with a doubled band; a window with no seed, or whose band misses
        the optimum, takes the full-window NumPy Gotoh.  The window scores
        are rounded on the host in float64, as the JAX package rounds
        them.  Counters: `traceback.batched`, `traceback.banded` and
        `traceback.full` count the windows of each route,
        `traceback.fill_seconds` the wall time of the call."""
        from unicore_tpu_torch.ops.sw_ref import sw_traceback_ref

        t_fill = time.perf_counter()
        p = self.params
        _qc_cache: Dict[int, np.ndarray] = {}

        def qbias_win(qidx: int, lo: int, hi: int):
            """Forward-pass bias values sliced to the hit window (same
            values the kernel scored with, so the traceback re-derives
            the kernel's optimal alignment)."""
            if not p.comp_bias_corr:
                return None
            if qidx not in _qc_cache:
                from unicore_tpu_torch.align.bias import composition_bias
                _qc_cache[qidx] = composition_bias(
                    np.asarray(q_aa[qidx])[None, :], np.asarray(q_ss[qidx])[None, :],
                    np.array([len(q_aa[qidx])]), self.saa, self.s3d,
                    p.w_aa, p.w_3di,
                )[0]
            return _qc_cache[qidx][lo:hi]

        def window_scores(qa, qs, ta, ts, qc_win):
            s = (
                p.w_aa * self.saa[qa[:, None], ta[None, :]]
                + p.w_3di * self.s3d[qs[:, None], ts[None, :]]
            )
            if qc_win is not None:
                s = s + np.asarray(qc_win)[:, None]
            return s

        def full_gotoh(qa, qs, ta, ts, qc_win):
            profiling.add_counter("traceback.full", 1)
            s = window_scores(qa, qs, ta, ts, None).astype(np.float64)
            if qc_win is not None:
                s = s + np.asarray(qc_win)[:, None]
            _, _, _, _, _, q_arr, t_arr = sw_traceback_ref(s, p.gap_open, p.gap_extend)
            return q_arr, t_arr

        # ---- batch the short windows' forward DPs on the device ----
        short_keys: List[int] = []
        short_S: List[np.ndarray] = []
        for k, h in enumerate(hits):
            wq = h.qend - h.qstart + 1
            wt = h.tend - h.tstart + 1
            if not (p.long_threshold and max(wq, wt) > p.long_threshold):
                qa = q_aa[h.qidx][h.qstart : h.qend + 1]
                qs = q_ss[h.qidx][h.qstart : h.qend + 1]
                ta = t_aa[h.tidx][h.tstart : h.tend + 1]
                ts = t_ss[h.tidx][h.tstart : h.tend + 1]
                s = window_scores(qa, qs, ta, ts, qbias_win(h.qidx, h.qstart, h.qend + 1))
                short_keys.append(k)
                short_S.append(np.rint(s).astype(np.int32))
        short_paths: Dict[int, tuple] = {}
        if short_S:
            from unicore_tpu_torch.ops.sw_bits import sw_traceback_batch
            res = sw_traceback_batch(
                short_S, int(p.gap_open), int(p.gap_extend), device=self.device)
            for k, (q_arr, t_arr, _) in zip(short_keys, res):
                short_paths[k] = (q_arr, t_arr)
        profiling.add_counter("traceback.batched", len(short_S))

        for k, h in enumerate(hits):
            qa = q_aa[h.qidx][h.qstart : h.qend + 1]
            qs = q_ss[h.qidx][h.qstart : h.qend + 1]
            ta = t_aa[h.tidx][h.tstart : h.tend + 1]
            ts = t_ss[h.tidx][h.tstart : h.tend + 1]
            qc_win = qbias_win(h.qidx, h.qstart, h.qend + 1)
            if k in short_paths:
                q_arr, t_arr = short_paths[k]
            elif p.long_threshold and max(len(qa), len(ta)) > p.long_threshold:
                # long window: banded traceback (O(L*W) instead of the
                # O(L^2) full DP matrices, which would be ~0.5 GB at 4k)
                from unicore_tpu_torch.ops.banded import (
                    band_scores_ref, sw_traceback_banded_ref, vote_diagonal,
                    vote_diagonal_sensitive,
                )
                d0 = vote_diagonal(qa, qs, ta, ts)
                wide = 0
                if d0 is None:
                    # sensitive fallback seeds (3Di-only / reduced-AA),
                    # doubled band — mirrors the forward banded pass
                    d0 = vote_diagonal_sensitive(qa, qs, ta, ts)
                    wide = 1
                if d0 is None:
                    # last resort: full-window Gotoh.  A hit reaching the
                    # traceback already passed the score/E-value gates,
                    # so it never gets fabricated m8 columns
                    # (convertalis, search.rs:56-61, reports only real
                    # alignments)
                    q_arr, t_arr = full_gotoh(qa, qs, ta, ts, qc_win)
                else:
                    profiling.add_counter("traceback.banded", 1)
                    W = max(p.band_width << wide,
                            ((abs(len(qa) - len(ta)) + 255) // 128) * 128)
                    sb, _ = band_scores_ref(qa, qs, ta, ts, d0, W,
                                            self.saa, self.s3d, p.w_aa, p.w_3di,
                                            qc=qc_win)
                    _, q_arr, t_arr = sw_traceback_banded_ref(
                        sb, d0, p.gap_open, p.gap_extend)
                    if len(q_arr) == 0:
                        # band missed the optimum entirely: full-window
                        # Gotoh rather than a fabricated row
                        q_arr, t_arr = full_gotoh(qa, qs, ta, ts, qc_win)
            else:  # unreachable: every short window is in short_paths
                raise AssertionError("short hit missing from batched traceback")
            # unreachable post-gating: a hit reaching traceback has
            # score > 0, so every path above yields a non-empty path; a
            # default fill here would be a fabricated m8 row, so fail
            # loudly instead
            assert len(q_arr) > 0, (
                f"empty traceback for gated hit q={h.qidx} t={h.tidx} "
                f"window=({h.qstart}:{h.qend},{h.tstart}:{h.tend}) "
                f"score={h.score}"
            )
            matches = 0
            mismatches = 0
            gapopens = 0
            in_gap = False
            for qi_, ti_ in zip(q_arr, t_arr):
                if qi_ >= 0 and ti_ >= 0:
                    in_gap = False
                    if qa[qi_] == ta[ti_]:
                        matches += 1
                    else:
                        mismatches += 1
                else:
                    if not in_gap:
                        gapopens += 1
                    in_gap = True
            h.alnlen = len(q_arr)
            h.mismatch = mismatches
            h.gapopen = gapopens
            h.fident = matches / h.alnlen if h.alnlen else 0.0
        profiling.add_counter("traceback.fill_seconds", time.perf_counter() - t_fill)

    # ------------------------------------------------------------------
    def probe(self) -> bool:
        """config --check style self-test on tiny input."""
        qa = [np.array([0, 1, 2, 3, 4], np.int8)]
        hits = self.align_pairs(qa, qa, qa, qa, [(0, 0)])
        return len(hits) == 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _as_i32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """int32 tensor on `device`; host memory is pinned so the copy to a
    card is asynchronous (batches are dispatched before any is collected)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def encode_db(aa_seqs: Sequence[str], ss_seqs: Sequence[str]):
    """Encode sequences once into int code arrays."""
    q_aa = [encode_aa(s).astype(np.int32) for s in aa_seqs]
    q_ss = [encode_3di(s).astype(np.int32) for s in ss_seqs]
    return q_aa, q_ss
