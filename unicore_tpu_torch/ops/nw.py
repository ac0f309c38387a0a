"""Global (semi-global) profile-profile alignment for progressive MSA.

Replaces the per-gene MSA compute of `foldmason structuremsa` /
`mafft` (tree.rs:166-231 contract).  Profiles are (L, 21) frequency
matrices per channel (AA, and 3Di when structure-aware).  Column-pair
scores are two MXU-friendly matmuls:

    S = w_aa * (Fa_1 @ Saa) @ Fa_2^T + w_3di * (Fs_1 @ S3d) @ Fs_2^T

The DP itself is an affine-gap Needleman-Wunsch with cost-free terminal
gaps (semi-global), vectorized over the inner axis per row; traceback is
reconstructed from compact direction bits on the host.

Copy of unicore_tpu/ops/nw.py (the port imports nothing of the JAX
package).  `nw_align` is the host reference, the plain version that the
device DP of ops/nw_device.py is held against in the tests.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

NEG = -1e9

# Profile scores are quantized to integers (round(S * QUANT)) before the
# DP: integer arithmetic makes the host NumPy reference and the batched
# device DP (ops/nw_device.py) bit-identical — every max/add is exact,
# so tie-breaking decisions match with no float-reduction-order caveats.
# 256 keeps |S_q| within int16 (cells < ~9k in MSA units) while the
# 0.2%-of-a-unit rounding is far below profile-score noise.
QUANT = 256


def quantize_scores(S: np.ndarray) -> np.ndarray:
    """Deterministic integer quantization of a float score matrix."""
    return np.rint(np.asarray(S, dtype=np.float64) * QUANT).astype(np.int32)


def profile_scores(
    fa1: np.ndarray, fa2: np.ndarray, saa: np.ndarray,
    fs1: np.ndarray | None = None, fs2: np.ndarray | None = None,
    s3d: np.ndarray | None = None,
    w_aa: float = 1.0, w_3di: float = 0.0,
) -> np.ndarray:
    S = w_aa * (fa1 @ saa) @ fa2.T
    if w_3di and fs1 is not None and fs2 is not None and s3d is not None:
        S = S + w_3di * (fs1 @ s3d) @ fs2.T
    return S.astype(np.float32)


def nw_align(
    S: np.ndarray, go: float = 11.0, ge: float = 1.0, free_ends: bool = True
) -> Tuple[List[Tuple[int, int]], float]:
    """Affine-gap global alignment of an (L1, L2) score matrix.

    Returns (path, score) where path is a list of (i, j) pairs with -1
    marking a gap in that profile, covering all rows and columns in order.
    """
    L1, L2 = S.shape
    if L1 == 0:
        return [(-1, j) for j in range(L2)], 0.0
    if L2 == 0:
        return [(i, -1) for i in range(L1)], 0.0

    H = np.full((L1 + 1, L2 + 1), NEG, dtype=np.float64)
    E = np.full((L1 + 1, L2 + 1), NEG, dtype=np.float64)  # gap in profile 1 (move j)
    F = np.full((L1 + 1, L2 + 1), NEG, dtype=np.float64)  # gap in profile 2 (move i)
    H[0, 0] = 0.0
    if free_ends:
        H[0, 1:] = 0.0
        H[1:, 0] = 0.0
    else:
        H[0, 1:] = -go - ge * np.arange(L2)
        H[1:, 0] = -go - ge * np.arange(L1)

    jge = ge * np.arange(L2 + 1)
    for i in range(1, L1 + 1):
        F[i] = np.maximum(H[i - 1] - go, F[i - 1] - ge)
        diag = H[i - 1, :-1] + S[i - 1]
        h0 = np.maximum(diag, F[i, 1:])
        # E via prefix max (exact when go >= ge: a gap opened from an
        # E-derived cell is dominated by extending the earlier gap):
        #   E[j] = max_{k<j} (G[k] + k*ge) - go - (j-1)*ge
        # with G[0] = H[i][0] and G[k] = h0[k-1]
        G = np.empty(L2 + 1)
        G[0] = H[i, 0]
        G[1:] = h0
        P = np.maximum.accumulate(G[:-1] + jge[:-1])
        Escan = P - go - jge[1:] + ge
        H[i, 1:] = np.maximum(h0, Escan)
        # Gotoh-consistent E from the final row, so traceback identities
        # (H == E, E == H[j-1]-go) hold exactly
        P2 = np.maximum.accumulate(H[i, :-1] + jge[:-1])
        E[i, 1:] = P2 - go - jge[1:] + ge

    if free_ends:
        # end anywhere on last row/col; pick global best
        last_row_j = int(np.argmax(H[L1, :]))
        last_col_i = int(np.argmax(H[:, L2]))
        if H[L1, last_row_j] >= H[last_col_i, L2]:
            ei, ej = L1, last_row_j
        else:
            ei, ej = last_col_i, L2
        score = float(H[ei, ej])
    else:
        ei, ej = L1, L2
        score = float(H[L1, L2])

    # --- traceback ---
    path: List[Tuple[int, int]] = []
    # suffix (free end gaps)
    for j in range(L2 - 1, ej - 1, -1):
        path.append((-1, j))
    for i in range(L1 - 1, ei - 1, -1):
        path.append((i, -1))

    i, j = ei, ej
    state = "H"
    while i > 0 and j > 0:
        if free_ends and state == "H" and H[i, j] == 0 and (i == 0 or j == 0):
            break
        if state == "H":
            if H[i, j] == E[i, j]:
                state = "E"
                continue
            if H[i, j] == F[i, j]:
                state = "F"
                continue
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif state == "E":
            path.append((-1, j - 1))
            if E[i, j] == H[i, j - 1] - go:
                state = "H"
            j -= 1
        else:
            path.append((i - 1, -1))
            if F[i, j] == H[i - 1, j] - go:
                state = "H"
            i -= 1
    # prefix
    for jj in range(j - 1, -1, -1):
        path.append((-1, jj))
    for ii in range(i - 1, -1, -1):
        path.append((ii, -1))

    path.reverse()
    return path, score
