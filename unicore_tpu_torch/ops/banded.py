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
operation order: bit-identical to it on the same inputs.  It is the plain
version of the kernel in csrc/banded.cu (ops/banded_cuda.py), which runs
the engine's banded batches on a card.  The host
traceback of a long window (`band_scores_ref`, `sw_traceback_banded_ref`:
numpy float64 with NEG = -1e9, the m8 fill of align/engine.py's
`traceback_fill`) is a copy of the JAX package's.
`sw_forward_banded_sharded` runs a batch data-parallel over a device
mesh (parallel/mesh.py), one block of pairs per device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unicore_tpu_torch.ops.sw import NEG, _prefix_max
from unicore_tpu_torch.parallel.mesh import gather, on_device, shard, shard_devices

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


def row_limit(qlen, saa, s3d, W, go, ge, w_aa, w_3di, ungapped, qc, Lq) -> int:
    """Rows `sw_forward_banded` runs: up to the batch's longest qlen where
    the rows past it cannot change a result, else all Lq.  Rows past qlen
    score NEG: in the ungapped mode max(0, H + NEG) never passes an earlier
    H; in the gapped mode nothing can pass the best when the DP is exact
    (csrc/banded.cu's exact_dp): both weighted matrices integer-valued, go
    and ge integers >= 0, and qlen*(max|aa| + max|3di| + max|qc|) + W*ge +
    go + ge < 2^24, so every non-negative value is an exact integer."""
    top = int(qlen.clamp(0, Lq).max()) if qlen.numel() else 0
    if ungapped:
        return top
    aa, s3 = w_aa * saa.float(), w_3di * s3d.float()
    go32, ge32 = float(np.float32(go)), float(np.float32(ge))
    if not (torch.equal(aa, aa.round()) and torch.equal(s3, s3.round()) and go32 >= 0 and ge32 >= 0
            and go32.is_integer() and ge32.is_integer()):
        return Lq
    qmax = 0.0
    if qc is not None and top:
        rows = torch.arange(Lq, device=qc.device)[None, :] < qlen[:, None]
        qmax = float(torch.where(rows, qc.double().abs(), 0.0).max())
    bound = top * (float(aa.abs().max()) + float(s3.abs().max()) + qmax) + W * ge32 + go32 + ge32
    return top if bound < 2.0 ** 24 else Lq


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
    band; exact vs full SW whenever the optimum stays inside it.  The rows
    past the batch's longest qlen are skipped where `row_limit` allows."""
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
    for i in range(row_limit(qlen, saa, s3d, W, go, ge, w_aa, w_3di, ungapped, qc, Lq)):
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


def sw_forward_banded_sharded(
    qa, qs, ta, ts, qlen, tlen, d0,  # arrays or tensors, sw_forward_banded's shapes
    saa, s3d,                        # (21, 21): arrays, tensors or parallel.mesh.Replicas
    mesh,
    W: int = 256,
    go: float = 100.0,
    ge: float = 10.0,
    w_aa: float = 4.0,
    w_3di: float = 6.0,
    gap_window: int = 0,
    ungapped: bool = False,
    qc=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Banded forward data-parallel over the devices of `mesh`'s first
    axis (the long-pair analog of ops/sw_cuda.py::sw_forward_sharded):
    one block of pairs per device, each through
    `ops/banded_cuda.py::sw_forward_banded_cuda` on its device (the kernel
    on a card, the plain version on the CPU); bit-identical to one call on
    the whole batch.  B must be a multiple of the number of shards
    (align/engine.py pads).  Results come back in input order on the first
    shard's device."""
    from unicore_tpu_torch.ops.banded_cuda import sw_forward_banded_cuda

    devices = shard_devices(mesh)
    blocks = [shard(x, devices, torch.int32) for x in (qa, qs, ta, ts, qlen, tlen, d0)]
    qcs = [None] * len(devices) if qc is None else shard(qc, devices, torch.int32)
    outs = [sw_forward_banded_cuda(*(b[k] for b in blocks), on_device(saa, dev).float(),
                                   on_device(s3d, dev).float(), W=W, go=go, ge=ge, w_aa=w_aa,
                                   w_3di=w_3di, gap_window=gap_window, ungapped=ungapped, qc=qcs[k])
            for k, dev in enumerate(devices)]
    return tuple(gather([o[i] for o in outs], devices[0]) for i in range(3))


# ---------------------------------------------------------------------------
# host traceback (numpy float64; copies of the JAX package's)
# ---------------------------------------------------------------------------

def band_scores_ref(
    q_aa: np.ndarray, q_ss: np.ndarray, t_aa: np.ndarray, t_ss: np.ndarray,
    d0: int, W: int,
    saa: np.ndarray, s3d: np.ndarray, w_aa: float, w_3di: float,
    qc: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side banded score matrix (Lq, W) + the J index map."""
    Lq, Lt = len(q_aa), len(t_aa)
    W2 = W // 2
    J = np.arange(Lq)[:, None] + d0 + np.arange(W)[None, :] - W2
    valid = (J >= 0) & (J < Lt)
    Jc = np.clip(J, 0, Lt - 1)
    s = (
        w_aa * saa[q_aa[:, None], t_aa[Jc]]
        + w_3di * s3d[q_ss[:, None], t_ss[Jc]]
    ).astype(np.float64)
    if qc is not None:
        s = s + np.asarray(qc)[:, None]
    s[~valid] = NEG
    return s, J


def sw_traceback_banded_ref(
    s_band: np.ndarray,  # (Lq, W) banded scores (invalid cells ~NEG)
    d0: int,
    go: float, ge: float,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Banded Gotoh with traceback.

    Returns (score, q_idx, t_idx) in ORIGINAL coordinates — the same
    interface as sw_traceback_ref (-1 marks gap positions) — but with
    O(Lq*W) memory instead of O(Lq*Lt).  Cell (i, k) of the band is
    matrix cell (i, i + d0 + k - W/2)."""
    Lq, W = s_band.shape
    W2 = W // 2
    H = np.zeros((Lq + 1, W))
    E = np.full((Lq + 1, W), NEG)
    F = np.full((Lq + 1, W), NEG)
    jge = ge * np.arange(W)
    for i in range(1, Lq + 1):
        # up-predecessor is (i-1, k+1) in band coords
        H_up = np.concatenate([H[i - 1, 1:], [NEG]])
        F_up = np.concatenate([F[i - 1, 1:], [NEG]])
        F[i] = np.maximum(H_up - go, F_up - ge)
        h0 = np.maximum(0.0, np.maximum(H[i - 1] + s_band[i - 1], F[i]))
        # in-row prefix scan for E, then rebuild the Gotoh-consistent E
        # from the final row (same trick as sw_traceback_ref)
        P = np.maximum.accumulate(h0 + jge)
        Pexc = np.concatenate([[NEG], P[:-1]])
        H[i] = np.maximum(h0, Pexc - go + ge - jge)
        P2 = np.maximum.accumulate(H[i] + jge)
        P2exc = np.concatenate([[NEG], P2[:-1]])
        E[i] = P2exc - go + ge - jge
    flat = np.argmax(H)
    bi, bk = np.unravel_index(flat, H.shape)
    score = H[bi, bk]

    qi, kk = int(bi), int(bk)
    q_idx, t_idx = [], []
    state = "H"
    while qi > 0:
        j = (qi - 1) + d0 + kk - W2  # 0-based target index of cell (qi, kk)
        if j < 0:
            break
        h = H[qi, kk]
        if h == 0 and state == "H":
            break
        if state == "H":
            if h == E[qi, kk]:
                state = "E"
                continue
            if h == F[qi, kk]:
                state = "F"
                continue
            q_idx.append(qi - 1)
            t_idx.append(j)
            qi -= 1  # diag: same k
        elif state == "E":  # gap consuming target: left in band coords
            q_idx.append(-1)
            t_idx.append(j)
            if kk == 0:
                break
            if E[qi, kk] == H[qi, kk - 1] - go:
                state = "H"
            kk -= 1
        else:  # F: gap consuming query: up-right in band coords
            q_idx.append(qi - 1)
            t_idx.append(-1)
            if kk + 1 >= W:
                break
            if F[qi, kk] == H[qi - 1, kk + 1] - go:
                state = "H"
            qi -= 1
            kk += 1
    q_idx.reverse()
    t_idx.reverse()
    return float(score), np.array(q_idx, dtype=np.int32), np.array(t_idx, dtype=np.int32)
