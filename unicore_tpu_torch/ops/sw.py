"""Batched Smith-Waterman forward pass: the plain PyTorch versions.

Counterpart of unicore_tpu/ops/sw.py.  The same prefix-scan formulation
of the affine local-alignment recurrence, one DP row at a time:

    H0[j] = max(0, H[i-1][j-1] + s(i,j), F[i][j]),
    E[j]  = max_{k<j} (H0[k] + k*ge) - go - (j-1)*ge,    (windowed)
    H[j]  = max(H0[j], E[j]).

These functions run on any device and keep the JAX functions' float32
arithmetic in the same order, so on the same inputs their outputs are
bit-identical to `sw_forward_xla` / `ungapped_forward_xla`.  They are the
CPU path of the port and the reference that the Hopper kernel
(`ops/sw_cuda.py`, `csrc/sw.cu`) is held against; a Python loop over the
rows takes the place of `lax.scan`.

Ties resolve row-major: the lowest row holding the best score, then the
lowest column in that row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9
NA = 21  # alphabet size (20 + X) for both AA and 3Di channels

# Default integer scoring units (unicore_tpu/ops/sw.py): Foldseek's mean
# combined score 0.4*aa + 0.6*3di with gaps 10/1, scaled x10.
W_AA_INT = 4.0
W_3DI_INT = 6.0
GAP_OPEN_INT = 100.0
GAP_EXTEND_INT = 10.0

# (B, Lq, Lt) score elements built at once by `sw_forward_plain` on the
# CPU (on a card: 32x as many); larger batches are cut into pieces of
# independent pairs, which bounds the memory the score tensor takes
_PLAIN_CHUNK_CELLS = 1 << 25


def _prefix_max(t: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Inclusive prefix max along the last axis, in log-step shifts.

    `window > 0` caps the lookback: the steps d = 1, 2, 4, ... < window
    span the smallest power of two >= window, exactly as the JAX
    function does."""
    L = t.shape[-1]
    limit = L if not window else min(L, window)
    d = 1
    while d < limit:
        shifted = F.pad(t[..., :-d], (d, 0), value=NEG)
        t = torch.maximum(t, shifted)
        d *= 2
    return t


def _track_best(H, best, bi, bj, i):
    row_max = torch.amax(H, dim=1)
    row_arg = torch.argmax(H, dim=1).to(torch.int32)  # first max: lowest column
    upd = row_max > best
    return (torch.where(upd, row_max, best), bi.masked_fill(upd, i),
            torch.where(upd, row_arg, bj))


def sw_forward_xla(
    scores: torch.Tensor,  # (B, Lq, Lt) float32, padded cells already ~NEG
    go: float = GAP_OPEN_INT,
    ge: float = GAP_EXTEND_INT,
    gap_window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gapped (best, qend, tend) per pair; unicore_tpu.ops.sw.sw_forward_xla."""
    B, Lq, Lt = scores.shape
    dev = scores.device
    jge = (torch.arange(Lt, dtype=torch.float32, device=dev) * ge)[None, :]
    H = torch.zeros((B, Lt), dtype=torch.float32, device=dev)
    Fm = torch.full((B, Lt), NEG, dtype=torch.float32, device=dev)
    best = torch.zeros((B,), dtype=torch.float32, device=dev)
    bi = torch.zeros((B,), dtype=torch.int32, device=dev)
    bj = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(Lq):
        diag = F.pad(H[:, :-1], (1, 0))
        Fm = torch.maximum(H - go, Fm - ge)
        H0 = torch.clamp_min(torch.maximum(diag + scores[:, i, :], Fm), 0.0)
        P = _prefix_max(H0 + jge, window=gap_window)
        Pexc = F.pad(P[:, :-1], (1, 0), value=NEG)
        E = Pexc - go + ge - jge
        H = torch.maximum(H0, E)
        best, bi, bj = _track_best(H, best, bi, bj, i)
    return best, bi, bj


def ungapped_forward_xla(
    scores: torch.Tensor,  # (B, Lq, Lt) float32, padded cells already ~NEG
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Max ungapped diagonal segment score: every diagonal is an
    independent Kadane chain H[i][j] = max(0, H[i-1][j-1] + s[i][j]);
    unicore_tpu.ops.sw.ungapped_forward_xla."""
    B, Lq, Lt = scores.shape
    dev = scores.device
    H = torch.zeros((B, Lt), dtype=torch.float32, device=dev)
    best = torch.zeros((B,), dtype=torch.float32, device=dev)
    bi = torch.zeros((B,), dtype=torch.int32, device=dev)
    bj = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(Lq):
        diag = F.pad(H[:, :-1], (1, 0))
        H = torch.clamp_min(diag + scores[:, i, :], 0.0)
        best, bi, bj = _track_best(H, best, bi, bj, i)
    return best, bi, bj


def build_scores(
    qa: torch.Tensor, qs: torch.Tensor, ta: torch.Tensor, ts: torch.Tensor,
    qlen: torch.Tensor, tlen: torch.Tensor,
    saa: torch.Tensor, s3d: torch.Tensor,
    w_aa: float = W_AA_INT, w_3di: float = W_3DI_INT,
    qc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked (B, Lq, Lt) float32 combined score tensor; cells beyond a
    pair's lengths score NEG.  The bias `qc` is added in float64 and the
    sum rounded to float32, as NumPy does in the JAX function."""
    qa, qs, ta, ts = (x.long() for x in (qa, qs, ta, ts))
    s = (w_aa * saa[qa[:, :, None], ta[:, None, :]]
         + w_3di * s3d[qs[:, :, None], ts[:, None, :]])
    if qc is not None:
        s = (s.double() + qc[:, :, None].double()).float()
    B, Lq, Lt = s.shape
    qm = torch.arange(Lq, device=s.device)[None, :] < qlen[:, None]
    tm = torch.arange(Lt, device=s.device)[None, :] < tlen[:, None]
    mask = qm[:, :, None] & tm[:, None, :]
    return torch.where(mask, s, torch.tensor(NEG, dtype=torch.float32, device=s.device))


def sw_forward_plain(
    qa, qs, ta, ts, qlen, tlen, saa, s3d,
    go: float = GAP_OPEN_INT, ge: float = GAP_EXTEND_INT,
    w_aa: float = W_AA_INT, w_3di: float = W_3DI_INT,
    gap_window: int = 0, ungapped: bool = False,
    qc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain version: `build_scores` then the row scan, on
    the inputs of `sw_forward_cuda`.  Pairs are independent, so the batch
    is cut into pieces that bound the score tensor's size (see
    `_PLAIN_CHUNK_CELLS`); the results do not depend on the cut."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    cap = _PLAIN_CHUNK_CELLS if qa.device.type == "cpu" else _PLAIN_CHUNK_CELLS << 5
    step = max(1, cap // max(1, Lq * Lt))
    outs = []
    for s0 in range(0, B, step):
        sl = slice(s0, s0 + step)
        sc = build_scores(qa[sl], qs[sl], ta[sl], ts[sl], qlen[sl], tlen[sl],
                          saa, s3d, w_aa=w_aa, w_3di=w_3di,
                          qc=None if qc is None else qc[sl])
        if ungapped:
            outs.append(ungapped_forward_xla(sc))
        else:
            outs.append(sw_forward_xla(sc, go=go, ge=ge, gap_window=gap_window))
    if not outs:
        dev = qa.device
        return (torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))
