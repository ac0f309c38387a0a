"""Banded Smith-Waterman for long pairs — band-coordinate prefix-scan.

Counterpart of unicore_tpu/ops/banded.py.  Full-matrix SW is O(Lq*Lt) per
pair; pairs above the engine's `long_threshold` restrict the DP to a band
of width W around a seed diagonal and compute O(Lq*W) instead.

Seed diagonal: `vote_diagonal` matches exact combined AA+3Di 6-mers of
query and target on the host; each match votes for its diagonal
(t_pos - q_pos) and the smoothed histogram argmax is the band center.
The host helpers below are copies of the JAX package's.

Band coordinates: cell (i, k) is matrix cell (i, j) with
j = i + d0 + k - W/2.  The affine recurrence transforms to

    diag (i-1, j-1) -> (i-1, k)      same column!
    up   (i-1, j)   -> (i-1, k+1)    shift left
    left (i,   j-1) -> (i,   k-1)    in-row, same prefix-max scan

so the row scan is the prefix max of ops/sw.py and ties stay row-major in
the original (i, j) coordinates.

`sw_forward_banded` is plain PyTorch on the pair batch's device (the JAX
function is XLA code, not a Pallas kernel), in the JAX function's float32
operation order: bit-identical to it on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unicore_tpu_torch.ops.sw import NEG, _prefix_max

KMER_K = 6
_ALPHA2 = 441  # combined (aa, 3di) symbol alphabet: 21 * 21


def _combined_kmers(aa: np.ndarray, ss: np.ndarray, k: int = KMER_K) -> np.ndarray:
    """Exact integer k-mers over the combined AA+3Di alphabet.

    441^6 = 7.4e15 < 2^63, so the rolling product is exact in int64 —
    no hashing, no collisions."""
    c = aa.astype(np.int64) * 21 + ss.astype(np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    for i in range(k):
        v = v * _ALPHA2 + c[i : i + n]
    return v


def vote_diagonal(
    q_aa: np.ndarray, q_ss: np.ndarray, t_aa: np.ndarray, t_ss: np.ndarray,
    k: int = KMER_K, max_occ: int = 16, smooth: int = 8,
) -> Optional[int]:
    """Seed diagonal d0 = t_pos - q_pos from exact k-mer matches.

    Every (query k-mer == target k-mer) occurrence votes for its
    diagonal; k-mers occurring > max_occ times in the target are skipped
    (low-complexity guard).  Votes are smoothed over +-smooth diagonals
    (small indels shift the trace between nearby diagonals).  Returns
    None when not a single k-mer matches — for 6-mers over the combined
    441-letter alphabet that means the pair is unalignable junk."""
    qk = _combined_kmers(q_aa, q_ss, k)
    tk = _combined_kmers(t_aa, t_ss, k)
    return _vote_hist(qk, tk, len(q_aa), len(t_aa), max_occ, smooth)


def _vote_hist(
    qk: np.ndarray, tk: np.ndarray, Lq: int, Lt: int, max_occ: int, smooth: int,
    min_votes: int = 1,
) -> Optional[int]:
    """Diagonal histogram vote over exact integer k-mer matches.

    `min_votes`: the winning smoothed window must collect at least this
    many matches — a single chance match over a small alphabet must not
    seed a band (the sensitive fallback alphabets have non-negligible
    random match rates)."""
    if len(qk) == 0 or len(tk) == 0:
        return None
    order = np.argsort(tk, kind="stable")
    tks = tk[order]
    lo = np.searchsorted(tks, qk, "left")
    hi = np.searchsorted(tks, qk, "right")
    cnt = hi - lo
    sel = np.nonzero((cnt > 0) & (cnt <= max_occ))[0]
    if len(sel) == 0:
        return None
    tpos = np.concatenate([order[lo[i] : hi[i]] for i in sel])
    qpos = np.repeat(sel, cnt[sel])
    hist = np.zeros(Lq + Lt, dtype=np.int64)
    np.add.at(hist, tpos - qpos + Lq, 1)
    win = 2 * smooth + 1
    sm = np.convolve(hist, np.ones(win, dtype=np.int64), mode="same")
    arg = int(np.argmax(sm))
    if sm[arg] < min_votes:
        return None
    return arg - Lq


# Murphy-style 10-group reduced AA alphabet (+X): conservative
# substitutions (I/L/V/M, K/R, D/E/N/Q, F/Y/W, S/T) map to the same
# group, so distant homologs that share no exact 6-mer still share
# reduced k-mers.  Indexed by AA_FULL code order "ARNDCQEGHILKMFPSTWYV"+X.
REDUCED_AA_GROUPS = np.array(
    [2, 8, 7, 7, 1, 7, 7, 3, 9, 0, 0, 8, 0, 6, 5, 4, 4, 6, 6, 0, 10],
    dtype=np.int64,
)
_NGROUPS = 11


def _plain_kmers(sym: np.ndarray, alpha: int, k: int) -> np.ndarray:
    """Exact integer k-mers over a single small alphabet."""
    c = sym.astype(np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    for i in range(k):
        v = v * alpha + c[i : i + n]
    return v


def vote_diagonal_sensitive(
    q_aa: np.ndarray, q_ss: np.ndarray, t_aa: np.ndarray, t_ss: np.ndarray,
    smooth: int = 8,
) -> Optional[int]:
    """Fallback seed vote for pairs with no exact combined 6-mer
    (round-2 VERDICT: the recall cliff at zero votes).

    Two progressively wider nets, in order:
      1. 3Di-only exact 6-mers — structure is conserved far below the
         twilight zone of sequence identity (foldseek's core premise),
         so a distant structural homolog usually still shares 3Di words
         even when AA+3Di combined words are all broken.
      2. Reduced-alphabet AA 7-mers (Murphy 10 groups) — conservative
         substitutions stop breaking words.
    Higher max_occ guards compensate the smaller alphabets' higher
    random match rates; the smoothed histogram argmax drowns the extra
    noise votes.  Returns None only when both nets come up empty — the
    engine then routes the pair to full (unbanded) SW.
    """
    Lq, Lt = len(q_aa), len(t_aa)
    d0 = _vote_hist(
        _plain_kmers(np.asarray(q_ss), 21, 6), _plain_kmers(np.asarray(t_ss), 21, 6),
        Lq, Lt, max_occ=64, smooth=smooth, min_votes=3,
    )
    if d0 is not None:
        return d0
    qr = REDUCED_AA_GROUPS[np.asarray(q_aa, dtype=np.int64)]
    tr = REDUCED_AA_GROUPS[np.asarray(t_aa, dtype=np.int64)]
    return _vote_hist(
        _plain_kmers(qr, _NGROUPS, 7), _plain_kmers(tr, _NGROUPS, 7),
        Lq, Lt, max_occ=64, smooth=smooth, min_votes=3,
    )


def _channel_match_excess(qk: np.ndarray, tk: np.ndarray, alpha_pow: float,
                          max_occ: int = 64) -> bool:
    """True iff the number of exact k-mer matches exceeds the chance
    expectation for two random sequences by > 3 sigma (+2 floor)."""
    if len(qk) == 0 or len(tk) == 0:
        return False
    order = np.argsort(tk, kind="stable")
    cnt = np.searchsorted(tk[order], qk, "right") - np.searchsorted(tk[order], qk, "left")
    obs = int(np.minimum(cnt, max_occ).sum())
    exp = len(qk) * len(tk) / alpha_pow
    return obs > exp + 3.0 * np.sqrt(exp) + 2.0


def has_seed_evidence(
    q_aa: np.ndarray, q_ss: np.ndarray, t_aa: np.ndarray, t_ss: np.ndarray,
) -> bool:
    """Chance-corrected homology evidence for pairs whose diagonal votes
    all failed: do the 3Di or reduced-AA channels share significantly
    more k-mers than two random sequences would?  Gates the full-SW last
    resort — without it, every chance-level long candidate pair (hashed
    bag prefilters pass many at scale) would cost a full O(Lq*Lt) DP.
    Foldseek's prefilter drops such pairs too."""
    if _channel_match_excess(
        _plain_kmers(np.asarray(q_ss), 21, 6), _plain_kmers(np.asarray(t_ss), 21, 6),
        float(21) ** 6,
    ):
        return True
    qr = REDUCED_AA_GROUPS[np.asarray(q_aa, dtype=np.int64)]
    tr = REDUCED_AA_GROUPS[np.asarray(t_aa, dtype=np.int64)]
    return _channel_match_excess(
        _plain_kmers(qr, _NGROUPS, 7), _plain_kmers(tr, _NGROUPS, 7),
        float(_NGROUPS) ** 7,
    )


def sw_forward_banded(
    qa: torch.Tensor,    # (B, Lq) int32 AA codes (pad with X=20)
    qs: torch.Tensor,    # (B, Lq) int32 3Di codes
    ta: torch.Tensor,    # (B, Lt) int32
    ts: torch.Tensor,    # (B, Lt) int32
    qlen: torch.Tensor,  # (B,) int32
    tlen: torch.Tensor,  # (B,) int32
    d0: torch.Tensor,    # (B,) int32 seed diagonal (t_pos - q_pos)
    saa: torch.Tensor,   # (21, 21) f32
    s3d: torch.Tensor,   # (21, 21) f32
    W: int = 256,
    go: float = 100.0,
    ge: float = 10.0,
    w_aa: float = 4.0,
    w_3di: float = 6.0,
    gap_window: int = 0,
    ungapped: bool = False,
    qc: Optional[torch.Tensor] = None,  # (B, Lq) int32 per-query-row score correction
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, qend, tend) per pair over the band j in [i+d0-W/2, i+d0+W/2).

    Identical scoring/tie semantics to sw_forward_xla restricted to the
    band; exact vs full SW whenever the optimum stays inside it."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    W2 = W // 2
    dev = qa.device

    i_idx = torch.arange(Lq, dtype=torch.int32, device=dev)[None, :, None]  # (1, Lq, 1)
    k_idx = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]   # (1, 1, W)
    J = i_idx + d0[:, None, None] + k_idx - W2                              # (B, Lq, W)
    valid = (J >= 0) & (J < tlen[:, None, None]) & (i_idx < qlen[:, None, None])
    Jc = J.clamp(0, Lt - 1).long().reshape(B, -1)
    ta_g = torch.gather(ta.long(), 1, Jc).reshape(B, Lq, W)
    ts_g = torch.gather(ts.long(), 1, Jc).reshape(B, Lq, W)
    s = (w_aa * saa[qa.long()[:, :, None], ta_g]
         + w_3di * s3d[qs.long()[:, :, None], ts_g]).to(torch.float32)
    if qc is not None:
        s = s + qc[:, :, None].to(torch.float32)
    s = torch.where(valid, s, torch.tensor(NEG, dtype=torch.float32, device=dev))

    jge = (torch.arange(W, dtype=torch.float32, device=dev) * ge)[None, :]  # (1, W)
    H = torch.zeros((B, W), dtype=torch.float32, device=dev)
    Fm = torch.full((B, W), NEG, dtype=torch.float32, device=dev)
    best = torch.zeros((B,), dtype=torch.float32, device=dev)
    bi = torch.zeros((B,), dtype=torch.int32, device=dev)
    bk = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(Lq):
        s_row = s[:, i, :]
        if ungapped:
            # per-diagonal Kadane chain: in band coords a diagonal IS a
            # column, so the whole rescore is one add+max per row
            H = torch.clamp_min(H + s_row, 0.0)
        else:
            # up-predecessor shifts LEFT in band coords (see module doc)
            H_up = F.pad(H[:, 1:], (0, 1), value=NEG)
            F_up = F.pad(Fm[:, 1:], (0, 1), value=NEG)
            Fm = torch.maximum(H_up - go, F_up - ge)
            H0 = torch.clamp_min(torch.maximum(H + s_row, Fm), 0.0)
            P = _prefix_max(H0 + jge, window=gap_window)
            Pexc = F.pad(P[:, :-1], (1, 0), value=NEG)
            E = Pexc - go + ge - jge
            H = torch.maximum(H0, E)
        row_max = torch.amax(H, dim=1)
        # first max = lowest k = lowest j: row-major ties in (i, j)
        row_arg = torch.argmax(H, dim=1).to(torch.int32)
        upd = row_max > best
        best = torch.where(upd, row_max, best)
        bi = bi.masked_fill(upd, i)
        bk = torch.where(upd, row_arg, bk)
    tend = (bi + d0 + bk - W2).clamp(0, Lt - 1).to(torch.int32)
    return best, bi, tend
