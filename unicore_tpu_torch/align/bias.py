"""Composition-bias score correction (foldseek/MMseqs2 parity).

Foldseek runs its prefilter and gapped alignment with local composition
bias correction ON by default (`--comp-bias-corr 1`); the reference
pipeline therefore inherits it through every `foldseek cluster/search`
call (cluster.rs:43-55, search.rs:44-53).  Without it, low-complexity or
composition-biased regions (K/R-rich ribosomal proteins, helix-rich 3Di
runs) produce spuriously high pairwise scores and over-merge unrelated
sequences — measured on the 3-proteome fixture the missing correction
collapsed 79 clusters into 15.

The correction follows MMseqs2's local AA bias (CompositionBias.cpp):
for every query position i, with a +-half-window neighborhood N(i)
(window 40, excluding i itself),

    delta_i = sum_a pback[a] * S(a, x_i)  -  mean_{j in N(i)} S(x_j, x_i)

i.e. the expected score of x_i against the background MINUS its average
score against its own local composition.  delta_i is ADDED to every
alignment score in row i: self-similar (biased) regions score their own
context well, so delta_i goes negative and damps them; composition-
neutral regions get delta_i ~ 0 and are untouched.  The background is
uniform over the 20 real letters — the same null model the E-value
calibration simulates (align/stats.py), so corrected scores and fitted
statistics stay consistent.

Here the correction is applied per channel (AA and 3Di), weighted like
the scores themselves, and rounded to an integer so the integer-scoring
exactness contract of the kernels (bf16 score scratch, int16 DP path,
ops/sw.py) is preserved.
"""

from __future__ import annotations

import numpy as np

WINDOW = 40  # MMseqs2 default: +-20 residues


def _channel_delta(
    codes: np.ndarray,  # (B, L) int codes (any value >= nstates is ignored)
    qlen: np.ndarray,   # (B,)
    S: np.ndarray,      # (nstates, nstates) channel substitution matrix
    window: int,
    pback: np.ndarray = None,  # (20,) channel background (None = uniform)
) -> np.ndarray:
    """(B, L) float64 per-position delta for one channel."""
    B, L = codes.shape
    n = S.shape[0]
    hw = window // 2
    valid = np.arange(L)[None, :] < qlen[:, None]
    c = np.where(valid, codes, 0)

    # windowed one-hot counts via cumsum: counts[b, i] = histogram of
    # codes in [max(0, i-hw), min(qlen, i+hw+1))
    oh = np.zeros((B, L + 1, n), dtype=np.int32)
    oh[np.arange(B)[:, None], np.arange(1, L + 1)[None, :], c] = valid.astype(np.int32)
    C = np.cumsum(oh, axis=1)  # (B, L+1, n)
    pos = np.arange(L)
    lo = np.maximum(0, pos - hw)
    hi = np.minimum(qlen[:, None], pos[None, :] + hw + 1)
    counts = (
        C[np.arange(B)[:, None], hi] - C[np.arange(B)[:, None], lo[None, :]]
    ).astype(np.float64)  # (B, L, n)
    # exclude the position itself
    counts[np.arange(B)[:, None], np.arange(L)[None, :], c] -= valid
    wlen0 = counts.sum(axis=2)
    wlen = np.maximum(wlen0, 1.0)

    Scol = S[:, c]  # (n, B, L): S[a, x_i]
    win_mean = np.einsum("bla,abl->bl", counts, Scol) / wlen
    if pback is None:
        bg = Scol[:20].mean(axis=0)  # uniform over the 20 letters
    else:
        bg = np.einsum("a,abl->bl", pback, Scol[:20])
    # positions with an empty neighborhood (length-1 sequences) get 0
    return np.where(valid & (wlen0 > 0), bg - win_mean, 0.0)


def composition_bias(
    qa: np.ndarray, qs: np.ndarray, qlen: np.ndarray,
    saa: np.ndarray, s3d: np.ndarray,
    w_aa: float, w_3di: float,
    window: int = WINDOW,
) -> np.ndarray:
    """(B, Lq) int32 combined per-query-position score correction.

    Rounded to integers (exactness contract) and clipped so every
    COMBINED cell score s + qc stays within +-256 — the integer range
    bf16 represents exactly — because the kernel's score scratch is
    bf16 (ops/sw.py sc_ref).  The bound is computed from the actual
    matrices: |qc| <= 256 - max|w_aa*saa + w_3di*s3d| over the real
    code range, so matrix overrides (UNICORE_TPU_3DI_MATRIX) with a
    larger dynamic range tighten the clip automatically instead of
    silently breaking cross-backend byte-identity (a fixed +-255 clip
    measurably diverged the Pallas path from build_scores+XLA by up to
    14 units at |qc|~255).  Backgrounds: AA uniform (matches the
    BLOSUM-era convention and the calibration null), 3Di the published
    mat3di state background (the same null the E-value simulation
    samples from)."""
    from unicore_tpu_torch.matrices import get_3di_background

    d = (
        w_aa * _channel_delta(np.asarray(qa), qlen, np.asarray(saa), window)
        + w_3di * _channel_delta(np.asarray(qs), qlen, np.asarray(s3d), window,
                                 pback=get_3di_background())
    )
    bound = bias_clip_bound(saa, s3d, w_aa, w_3di)
    return np.clip(np.rint(d), -bound, bound).astype(np.int32)


def bias_clip_bound(saa: np.ndarray, s3d: np.ndarray,
                    w_aa: float, w_3di: float) -> float:
    """Largest |qc| that keeps every combined cell score s + qc an
    integer with |s + qc| <= 256 (exactly representable in the bf16
    score scratch).  max|s| is bounded by the per-channel maxima over
    the real (non-PAD) code range; the PAD sentinel rows (-2048) stay
    deeply negative regardless of qc so their bf16 rounding never
    affects the DP."""
    saa = np.asarray(saa, dtype=np.float64)
    s3d = np.asarray(s3d, dtype=np.float64)
    max_cell = (abs(w_aa) * np.abs(saa[:21, :21]).max()
                + abs(w_3di) * np.abs(s3d[:21, :21]).max())
    return max(0.0, np.floor(256.0 - max_cell))
