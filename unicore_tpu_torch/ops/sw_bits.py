"""Batched SW traceback via device direction bits — the m8 fill path.

Counterpart of unicore_tpu/ops/sw_bits.py, in PyTorch on the device of
its input tensors (the JAX function is XLA code, not a Pallas kernel).
The m8 columns (fident/alnlen/mismatch/gapopen, search.rs:56-61
convertalis contract) need the alignment path of every gated hit.  The
forward DP of many hit windows runs as one (B, L, L) integer DP on the
device, a Python loop over rows of int32 tensor ops, emitting compact
per-cell direction bits; the host walks each path in O(path) from the
bits (the same device-forward/host-decode split as ops/nw_device.py).

Exactness: scores are integers (combined substitution units plus the
integer composition-bias corrections), the DP is int32, prefix maxima are
`torch.cummax` (max is exact in any association), and the bits encode
exactly the equality tests of the NumPy golden model (ops/sw_ref.py
sw_traceback_ref):

    bit0  H[i,j] == E[i,j]        (traceback prefers E)
    bit1  H[i,j] == F[i,j]        (then F; else diagonal)
    bit2  E[i,j] == H[i,j-1]-go   (gap-open while in E)
    bit3  F[i,j] == H[i-1,j]-go   (gap-open while in F)
    bit4  H[i,j] == 0             (local-alignment stop)

so the bits, end cells and scores are bit-identical to the JAX function's
and the decoded paths to sw_traceback_ref's, on every device.

Counters (runtime/profiling.py): `traceback.dispatches` counts the calls
of `sw_forward_bits`; `traceback.seconds` is the host wall time inside
them plus `sw_traceback_batch`'s collection (the wait for the results,
their copy to the host and the path walks).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import profiling

INT_NEG = -(2 ** 28)
PAD_SCORE = -20000


def sw_forward_bits(
    S: torch.Tensor,   # (B, L1, L2) int16/int32 integer scores (pad <= 0)
    l1: torch.Tensor,  # (B,) int32 true row counts
    l2: torch.Tensor,  # (B,) int32 true col counts
    go: int,
    ge: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local (SW) affine forward emitting direction bits, on S's device.

    Returns (bits (B, L1, L2) uint8, best_i (B,), best_j (B,), score
    (B,)), int32 apart from the bits; best_i/best_j are 0-based end
    cells, -1 when the best is 0 (empty alignment).  Ties resolve
    row-major like np.argmax over the full H matrix (lowest i, then
    lowest j): `torch.argmax` over the flattened valid cells returns the
    first maximum.

    The JAX function's row step, with its integer terms regrouped
    (P - go - j*ge + ge == P - (j*ge + go - ge), exact in int32).  Only
    the recurrence of H and F runs row by row; every row of both is kept,
    and E, the direction bits and the end cell are computed for all rows
    at once after the loop."""
    t0 = time.perf_counter()
    B, L1, L2 = S.shape
    dev = S.device
    go, ge = int(go), int(ge)
    l1 = l1.to(dev, torch.int32)
    l2 = l2.to(dev, torch.int32)
    jge = torch.arange(L2 + 1, dtype=torch.int32, device=dev) * ge
    jge_lo = jge[:-1]                 # k*ge, k = 0..L2-1
    jge_hi = jge[1:] + (go - ge)      # Escan = P - go - j*ge + ge

    # row 0 and column 0 of H stay 0, as allocated
    H = torch.zeros((B, L1 + 1, L2 + 1), dtype=torch.int32, device=dev)
    F = torch.empty((B, L1 + 1, L2 + 1), dtype=torch.int32, device=dev)
    F[:, 0] = INT_NEG
    G = torch.zeros((B, L2), dtype=torch.int32, device=dev)  # G[:, 0] = H[i, 0] = 0
    H_go = H[:, 0] - go
    for i in range(1, L1 + 1):
        F_i = torch.maximum(H_go, F[:, i - 1] - ge, out=F[:, i])          # (B, L2+1)
        h0 = torch.maximum(H[:, i - 1, :-1] + S[:, i - 1], F_i[:, 1:]).clamp_(min=0)
        # E scan from h0 (exact when go >= ge), as the reference
        torch.add(h0[:, :-1], jge_lo[1:], out=G[:, 1:])
        Escan = torch.cummax(G, dim=1).values - jge_hi
        torch.maximum(h0, Escan, out=H[:, i, 1:])
        H_go = H[:, i] - go

    # Gotoh-consistent E from the final rows (traceback identities)
    H_in, F1 = H[:, 1:, 1:], F[:, 1:, 1:]
    E = torch.cummax(H[:, 1:, :-1] + jge_lo, dim=2).values - jge_hi
    # bits = b0 | b1 << 1 | b2 << 2 | b3 << 3 | b4 << 4, in Horner form
    bits = (H_in == 0).to(torch.uint8)
    bits = torch.add(F1 == H[:, :-1, 1:] - go, bits, alpha=2)
    bits = torch.add(E == H[:, 1:, :-1] - go, bits, alpha=2)
    bits = torch.add(H_in == F1, bits, alpha=2)
    bits = torch.add(H_in == E, bits, alpha=2)
    del E

    # best cell over the valid region, first maximum in row-major order
    rows = torch.arange(L1, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(L2, dtype=torch.int32, device=dev)[None, None, :]
    valid = (rows < l1[:, None, None]) & (cols < l2[:, None, None])
    Hv = torch.where(valid, H_in, INT_NEG).reshape(B, L1 * L2)
    score = torch.amax(Hv, dim=1)
    flat = torch.argmax(Hv, dim=1)  # the first maximum
    found = score > 0
    neg1 = torch.full_like(score, -1)
    bi = torch.where(found, (flat // L2).to(torch.int32), neg1)
    bj = torch.where(found, (flat % L2).to(torch.int32), neg1)
    score = torch.where(found, score, torch.zeros_like(score))
    profiling.add_counter("traceback.dispatches", 1)
    profiling.add_counter("traceback.seconds", time.perf_counter() - t0)
    return bits, bi, bj, score


def decode_sw_path(
    bits: np.ndarray, bi: int, bj: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Walk the bits from end cell (bi, bj) (0-based) — the exact
    decision sequence of sw_traceback_ref (E preferred, then F, else
    diagonal; stop at H==0, detected as leaving via a diagonal step
    whose predecessors are exhausted)."""
    q_idx: List[int] = []
    t_idx: List[int] = []
    if bi < 0 or bj < 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    i, j = bi + 1, bj + 1  # 1-based DP coords
    state = "H"
    while i > 0 and j > 0:
        b = bits[i - 1, j - 1]
        if state == "H":
            if b & 16:  # H == 0 marker
                break
            if b & 1:
                state = "E"
                continue
            if b & 2:
                state = "F"
                continue
            q_idx.append(i - 1)
            t_idx.append(j - 1)
            i -= 1
            j -= 1
        elif state == "E":
            q_idx.append(-1)
            t_idx.append(j - 1)
            if b & 4:
                state = "H"
            j -= 1
        else:
            q_idx.append(i - 1)
            t_idx.append(-1)
            if b & 8:
                state = "H"
            i -= 1
    q_idx.reverse()
    t_idx.reverse()
    return np.array(q_idx, dtype=np.int32), np.array(t_idx, dtype=np.int32)


def _bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def sw_traceback_batch(
    S_list: List[np.ndarray], go: int, ge: int, batch_size: int = 64, device=None,
) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """Batched device traceback over many integer score windows.

    Returns [(q_idx, t_idx, score), ...] in order, identical to
    sw_traceback_ref's (q_arr, t_arr, score) on each window.  Windows
    are bucketed to square pow2 shapes from 64 (the JAX package's
    shape classes), a batch holds at most 64 MB of int16 scores, and all
    batches dispatch before any decode.  `device`: where the DPs run
    (runtime/device.py decides when None)."""
    dev = device_mod.resolve(device)
    out: List = [None] * len(S_list)
    buckets = {}
    for k, S in enumerate(S_list):
        L1, L2 = S.shape
        if L1 == 0 or L2 == 0:
            out[k] = (np.zeros(0, np.int32), np.zeros(0, np.int32), 0.0)
            continue
        buckets.setdefault(_bucket(max(L1, L2)), []).append(k)

    inflight = []
    for Lb, idxs in sorted(buckets.items()):
        bsz = max(1, min(batch_size, (64 << 20) // (Lb * Lb * 2)))
        for s0 in range(0, len(idxs), bsz):
            chunk = idxs[s0 : s0 + bsz]
            B = bsz if len(idxs) > bsz else min(
                bsz, max(4, 1 << (len(chunk) - 1).bit_length())
            )
            Sp = np.full((B, Lb, Lb), PAD_SCORE, dtype=np.int16)
            l1 = np.ones(B, dtype=np.int32)
            l2 = np.ones(B, dtype=np.int32)
            for row, k in enumerate(chunk):
                a, b = S_list[k].shape
                Sk = S_list[k]
                assert int(Sk.max(initial=0)) < -PAD_SCORE and \
                    int(Sk.min(initial=0)) > PAD_SCORE, "score exceeds int16"
                Sp[row, :a, :b] = Sk
                l1[row], l2[row] = a, b
            res = sw_forward_bits(
                torch.from_numpy(Sp).to(dev), torch.from_numpy(l1).to(dev),
                torch.from_numpy(l2).to(dev), int(go), int(ge),
            )
            inflight.append((chunk, res))
    t0 = time.perf_counter()
    for chunk, (bits, bi, bj, score) in inflight:
        bits = bits.cpu().numpy()
        bi, bj, score = bi.cpu().numpy(), bj.cpu().numpy(), score.cpu().numpy()
        for row, k in enumerate(chunk):
            q_arr, t_arr = decode_sw_path(bits[row], int(bi[row]), int(bj[row]))
            out[k] = (q_arr, t_arr, float(score[row]))
    profiling.add_counter("traceback.seconds", time.perf_counter() - t0)
    return out
