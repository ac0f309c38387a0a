"""Candidate-pair prefilter: hashed k-mer bags and one gram product.

Counterpart of unicore_tpu/align/prefilter.py.  Every sequence becomes a
D-dimensional binary bag of feature-hashed k-mers (3Di and AA trigram
channels hashed into one space), built on the host by the native C++
featurizer (unicore_tpu_torch.native); all-vs-all shared k-mer counts are one
(N, D) x (D, N) matrix product on the device.  Pairs sharing >= min_shared
hashed k-mers (and passing the length-ratio bound implied by the coverage
threshold) become SW candidates.

The product runs in float64, so the counts are exact integers whatever
the process's float32 matmul precision (TF32) is set to; they are then
handed to the host as float32, the type the JAX function produces, so
every threshold below is computed in the same arithmetic.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from unicore_tpu_torch import native
from unicore_tpu_torch.alphabets import encode_3di, encode_aa
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import profiling

DEFAULT_DIM = 2048
_MULT = np.uint64(0x9E3779B97F4A7C15)


def _kmer_hashes(codes: np.ndarray, k: int, channel: int) -> np.ndarray:
    """Rolling integer k-mers -> 64-bit mixed hashes."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    v = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        v = v * np.uint64(21) + codes[i : i + n].astype(np.uint64)
    v = (v + np.uint64(channel) * np.uint64(0x1000003)) * _MULT
    v ^= v >> np.uint64(29)
    return v


def featurize(aa_seqs: List[str], ss_seqs: List[str], k: int = 3, dim: int = DEFAULT_DIM) -> np.ndarray:
    """Binary (N, dim) float32 feature-bag matrix, through the
    multithreaded C++ featurizer (unicore_tpu_torch.native, built at
    first use; a failed build raises).  Bit-identical to
    `featurize_plain`.  Counter: `prefilter.featurize.seconds`."""
    t0 = time.perf_counter()
    N = len(aa_seqs)
    feats = np.zeros((N, dim), dtype=np.float32)
    if N:
        native.featurize_native([encode_aa(s) for s in aa_seqs], k, dim, 0, feats)
        native.featurize_native([encode_3di(s) for s in ss_seqs], k, dim, 1, feats)
    profiling.add_counter("prefilter.featurize.seconds", time.perf_counter() - t0)
    return feats


def featurize_plain(aa_seqs: List[str], ss_seqs: List[str], k: int = 3, dim: int = DEFAULT_DIM) -> np.ndarray:
    """`featurize`'s plain version: the same bags from a Python loop over
    the sequences (the JAX package's reference path)."""
    N = len(aa_seqs)
    feats = np.zeros((N, dim), dtype=np.float32)
    for i in range(N):
        ha = _kmer_hashes(encode_aa(aa_seqs[i]), k, 0) % np.uint64(dim)
        hs = _kmer_hashes(encode_3di(ss_seqs[i]), k, 1) % np.uint64(dim)
        feats[i, ha.astype(np.int64)] = 1.0
        feats[i, hs.astype(np.int64)] = 1.0
    return feats


def candidate_pairs(
    aa_seqs: List[str],
    ss_seqs: List[str],
    min_shared: int = 2,
    dim: int = DEFAULT_DIM,
    coverage: float = 0.0,
    target_aa: List[str] | None = None,
    target_ss: List[str] | None = None,
    block: int = 4096,
    sens: float = 5.7,
    max_seqs: int = 0,
    device=None,
) -> List[Tuple[int, int]]:
    """Return candidate (i, j) pairs.

    All-vs-all mode (target_* None): i < j over one set.
    Search mode: i indexes the query set, j the target set.

    `sens` is the foldseek `-s` sensitivity analog: it scales the
    chance-excess sigma multiplier (higher s => lower threshold => more
    candidates).  `max_seqs` (foldseek --max-seqs) caps candidates per
    query, keeping the highest shared-k-mer excess ones; 0 = unlimited.
    `device`: where the gram product runs (runtime/device.py decides
    when None).
    """
    dev = device_mod.resolve(device)
    fq = featurize(aa_seqs, ss_seqs, dim=dim)
    symmetric = target_aa is None
    ft = fq if symmetric else featurize(target_aa, target_ss, dim=dim)
    lens_q = np.array([len(s) for s in aa_seqs])
    lens_t = lens_q if symmetric else np.array([len(s) for s in target_aa])

    Nq, Nt = fq.shape[0], ft.shape[0]
    pairs: List[Tuple[int, int]] = []
    ftj = torch.from_numpy(ft.T.astype(np.float64)).to(dev)

    # chance-overlap correction: two unrelated bags with set bits kq, kt
    # share ~ dim * (kq/dim) * (kt/dim) features; require an excess of
    # max(min_shared, nsigma*sigma) over that expectation.  nsigma is the
    # sensitivity dial: 3.0 at the default -s 5.7, scaled inversely with
    # s and clamped to [1.5, 6.0].
    nsigma = float(np.clip(3.0 * (5.7 / max(sens, 0.1)), 1.5, 6.0))
    kq = fq.sum(axis=1)
    kt = ft.sum(axis=1)
    for i0 in range(0, Nq, block):
        i1 = min(i0 + block, Nq)
        fqi = torch.from_numpy(fq[i0:i1].astype(np.float64)).to(dev)
        shared = (fqi @ ftj).to(torch.float32).cpu().numpy()  # (b, Nt), exact counts
        for ii in range(i1 - i0):
            i = i0 + ii
            expected = kq[i] * kt / dim
            excess = shared[ii] - expected
            thr = np.maximum(min_shared, nsigma * np.sqrt(expected + 1.0))
            cand = np.nonzero(excess >= thr)[0]
            if coverage > 0:
                lr = np.minimum(lens_q[i], lens_t[cand]) / np.maximum(lens_q[i], lens_t[cand])
                cand = cand[lr >= coverage]
            if symmetric:
                cand = cand[cand > i]
            if max_seqs and len(cand) > max_seqs:
                top = np.argsort(-excess[cand], kind="stable")[:max_seqs]
                cand = np.sort(cand[top])
            pairs.extend((i, int(j)) for j in cand)
    return pairs
