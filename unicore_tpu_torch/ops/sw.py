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

`sw_forward_plain(..., dp_dtype="i16")` is the plain version of the
Pallas kernel's int16 DP (`sw_forward_pallas(dp_dtype="i16")`), a
function of its own: the scores pass through bfloat16, cells past a
pair's lengths score the pad sentinel, every operation wraps in int16,
and the gapped mode caps H at H_CAP (see `sw_forward_i16`).
"""

from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# int16 DP: the Pallas kernel's dp_dtype="i16" (unicore_tpu/ops/sw.py:228-252,
# :361-403, its host contract :596-634)
# ---------------------------------------------------------------------------

DP_DTYPES = ("f32", "i16")
NEG_I16 = -20000  # the int16 DP's outside: F's start and the scan's fill
H_CAP = 30000     # the gapped mode caps H here, after H = max(H0, E)
PAD = NA          # code of a position past a pair's length
I16_MIN, I16_MAX = -(1 << 15), (1 << 15) - 1


def i16_contract(Lq: int, Lt: int, go: float, ge: float, w_aa: float, w_3di: float) -> None:
    """Raise ValueError on what sw_forward_pallas(dp_dtype="i16") refuses:
    its asserts (go, ge, w_aa and w_3di integers, Lt*ge + 30150 < 32767,
    Lq < 32768, the pad sentinel in [20000, 32000) and above 15000) and
    the int16 constants it cannot make (go, ge and go - ge in int16).
    Its assert on the batch tile and chains is a TPU layout rule: this
    port has neither."""
    vals = dict(go=go, ge=ge, w_aa=w_aa, w_3di=w_3di)
    for name, v in vals.items():
        if not math.isfinite(float(v)) or float(v) != int(v):
            raise ValueError(f"dp_dtype='i16' needs an integer {name}, got {v}")
    if not Lt * ge + H_CAP + 150 < I16_MAX:
        raise ValueError(f"dp_dtype='i16' needs Lt*ge + 30150 < 32767 (no int16 wrap), "
                         f"got Lt={Lt}, ge={ge}")
    if not Lq < 1 << 15:
        raise ValueError(f"dp_dtype='i16' keeps the best row in int16: needs Lq < 32768, got {Lq}")
    for name, v in (("go", int(go)), ("ge", int(ge)), ("go - ge", int(go) - int(ge))):
        if not I16_MIN <= v <= I16_MAX:
            raise ValueError(f"dp_dtype='i16' needs {name} in int16, got {v}")
    i16_pad_value(w_aa, w_3di)


def i16_pad_value(w_aa: float, w_3di: float) -> int:
    """The pad row and column's value per channel, pad_v: cells past a
    pair's lengths score -pad_v*(w_aa + w_3di), the sentinel, computed as
    sw_forward_pallas does (bfloat16-exact, adaptive to the weights)."""
    wsum = float(w_aa) + float(w_3di)
    if not wsum > 0:
        raise ValueError(f"dp_dtype='i16' needs w_aa + w_3di > 0, got {wsum}")
    pad_v0 = math.ceil(20480.0 / wsum)
    gran = 1 << max(0, pad_v0.bit_length() - 8)
    pad_v = -(-pad_v0 // gran) * gran
    sent = pad_v * wsum
    if not (20000.0 <= sent < 32000.0 and H_CAP - sent < sent):
        raise ValueError(f"dp_dtype='i16': the pad sentinel {sent} of w_aa={w_aa}, "
                         f"w_3di={w_3di} is outside [20000, 32000)")
    return pad_v


def i16_tables(saa: torch.Tensor, s3d: torch.Tensor, w_aa: float, w_3di: float):
    """(22, 22) float32 tables of the weighted matrices as the Pallas
    kernel's score profiles hold them: a pad row and column (code PAD) of
    -pad_v, times the weight in float32, rounded to bfloat16."""
    pad_v = i16_pad_value(w_aa, w_3di)
    out = []
    for m, w in ((saa, w_aa), (s3d, w_3di)):
        t = torch.full((NA + 1, NA + 1), -float(pad_v), dtype=torch.float32, device=m.device)
        t[:NA, :NA] = m.float()
        out.append((t * float(w)).to(torch.bfloat16).float())
    return tuple(out)


def build_scores_i16(qa, qs, ta, ts, qlen, tlen, tab_aa, tab_3d,
                     qc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Lq, Lt) int16 scores as the Pallas kernel's int16 DP reads
    them: positions past a pair's lengths take code PAD, the bias is zero
    on rows past qlen and rounded to bfloat16 (through float32), and the
    float32 sum (aa + 3di) + bias goes through bfloat16 to int16."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    dev = qa.device
    qm = torch.arange(Lq, device=dev)[None, :] < qlen[:, None]
    tm = torch.arange(Lt, device=dev)[None, :] < tlen[:, None]
    qa, qs = (torch.where(qm, x, PAD).long() for x in (qa, qs))
    ta, ts = (torch.where(tm, x, PAD).long() for x in (ta, ts))
    s = tab_aa[qa[:, :, None], ta[:, None, :]] + tab_3d[qs[:, :, None], ts[:, None, :]]
    if qc is not None:
        qb = torch.where(qm, qc, 0).float().to(torch.bfloat16).float()
        s = s + qb[:, :, None]
    # to int16 as XLA converts: toward zero, saturating (torch's cast wraps)
    return s.to(torch.bfloat16).float().clamp(I16_MIN, I16_MAX).to(torch.int16)


def sw_forward_i16(
    scores: torch.Tensor,  # (B, Lq, Lt) int16 from build_scores_i16
    go: float = GAP_OPEN_INT,
    ge: float = GAP_EXTEND_INT,
    gap_window: int = 0,
    ungapped: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best f32, qend, tend) of the Pallas kernel's int16 DP, one row at a
    time in torch.int16 and in its operation order, every add and
    subtract wrapping as JAX's int16 ops do:

        F  = max(H[i-1] - go, F[i-1] - ge)              (F starts at -20000)
        H0 = max(0, max(H[i-1][j-1] + s, F))
        t  = H0 + j*ge, then the log-step windowed max, -20000 outside
        E  = t[j-1] - (j*ge + (go - ge))                (-20000 - ... at j = 0)
        H  = min(max(H0, E), 30000)

    and in the ungapped mode H = max(0, H[i-1][j-1] + s), with no cap.
    The per-column best is updated on a strict >, its row kept in int16;
    the pair's end is the lowest (row, column) holding the best.  Any Lt
    works (the Pallas kernel is right only at powers of two)."""
    B, Lq, Lt = scores.shape
    dev = scores.device
    i16 = torch.int16
    col = torch.arange(Lt, dtype=torch.int32, device=dev)
    jge = (col * int(ge)).to(i16)
    jge_go = jge + (int(go) - int(ge))
    limit = Lt if not gap_window else min(Lt, gap_window)
    H = torch.zeros((B, Lt), dtype=i16, device=dev)
    Fm = torch.full((B, Lt), NEG_I16, dtype=i16, device=dev)
    BB = torch.zeros((B, Lt), dtype=i16, device=dev)
    BR = torch.zeros((B, Lt), dtype=i16, device=dev)
    for i in range(Lq):
        diag = F.pad(H[:, :-1], (1, 0))
        if ungapped:
            H = torch.clamp_min(diag + scores[:, i, :], 0)
        else:
            Fm = torch.maximum(H - int(go), Fm - int(ge))
            H0 = torch.clamp_min(torch.maximum(diag + scores[:, i, :], Fm), 0)
            t = H0 + jge
            d = 1
            while d < limit:
                t = torch.maximum(t, F.pad(t[:, :-d], (d, 0), value=NEG_I16))
                d *= 2
            E = F.pad(t[:, :-1], (1, 0), value=NEG_I16) - jge_go
            H = torch.clamp_max(torch.maximum(H0, E), H_CAP)
        upd = H > BB
        BB = torch.where(upd, H, BB)
        BR = BR.masked_fill(upd, i)
    best = BB.amax(dim=1)
    key = BR.int() * Lt + col
    minkey = torch.where(BB >= best[:, None], key, 1 << 30).amin(dim=1)
    qend = minkey // Lt
    return best.float(), qend, minkey - qend * Lt


def sw_forward_plain(
    qa, qs, ta, ts, qlen, tlen, saa, s3d,
    go: float = GAP_OPEN_INT, ge: float = GAP_EXTEND_INT,
    w_aa: float = W_AA_INT, w_3di: float = W_3DI_INT,
    gap_window: int = 0, ungapped: bool = False,
    qc: Optional[torch.Tensor] = None,
    dp_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain version: `build_scores` then the row scan, on
    the inputs of `sw_forward_cuda`; with dp_dtype="i16",
    `build_scores_i16` then `sw_forward_i16`, after `i16_contract`.
    Pairs are independent, so the batch is cut into pieces that bound
    the score tensor's size (see `_PLAIN_CHUNK_CELLS`); the results do
    not depend on the cut."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    if dp_dtype not in DP_DTYPES:
        raise ValueError(f"dp_dtype must be one of {DP_DTYPES}, got {dp_dtype!r}")
    if dp_dtype == "i16":
        i16_contract(Lq, Lt, go, ge, w_aa, w_3di)
        tabs = i16_tables(saa, s3d, w_aa, w_3di)
    cap = _PLAIN_CHUNK_CELLS if qa.device.type == "cpu" else _PLAIN_CHUNK_CELLS << 5
    step = max(1, cap // max(1, Lq * Lt))
    outs = []
    for s0 in range(0, B, step):
        sl = slice(s0, s0 + step)
        if dp_dtype == "i16":
            sc = build_scores_i16(qa[sl], qs[sl], ta[sl], ts[sl], qlen[sl], tlen[sl], *tabs,
                                  qc=None if qc is None else qc[sl])
            outs.append(sw_forward_i16(sc, go=go, ge=ge, gap_window=gap_window, ungapped=ungapped))
            continue
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
