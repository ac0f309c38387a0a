"""Reference (NumPy) Smith-Waterman implementations.

Counterpart of unicore_tpu/ops/sw_ref.py (a copy: the port imports
nothing of the JAX package).  These are the golden models of the SW
kernel and of the batched traceback (ops/sw_bits.py), and the traceback
engine for the few long windows whose band misses (m8 output columns).
Classic Gotoh affine-gap DP in host float64:

    H[i][j] = max(0, H[i-1][j-1] + s(i,j), E[i][j], F[i][j])
    E[i][j] = max(H[i][j-1] - go, E[i][j-1] - ge)   (gap in query / along target)
    F[i][j] = max(H[i-1][j] - go, F[i-1][j] - ge)   (gap in target / along query)

Replaces the in-binary alignment of `foldseek cluster/search`
(cluster.rs:43-55, search.rs:44-53) — contract only; code is original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -1e9


def sw_score_matrix(q_codes: np.ndarray, t_codes: np.ndarray, S: np.ndarray) -> np.ndarray:
    return S[q_codes[:, None], t_codes[None, :]].astype(np.float64)


def sw_forward_ref(scores: np.ndarray, go: float, ge: float) -> Tuple[float, int, int]:
    """Best local score and its end cell (qend, tend), 0-based inclusive."""
    Lq, Lt = scores.shape
    H = np.zeros(Lt + 1)
    E = np.full(Lt + 1, NEG)
    F = np.full(Lt + 1, NEG)
    best, bi, bj = 0.0, -1, -1
    for i in range(1, Lq + 1):
        Hdiag = 0.0
        Hnew = np.zeros(Lt + 1)
        Ei = NEG
        for j in range(1, Lt + 1):
            Ei = max(Hnew[j - 1] - go, Ei - ge)
            F[j] = max(H[j] - go, F[j] - ge)
            h = max(0.0, Hdiag + scores[i - 1, j - 1], Ei, F[j])
            Hdiag = H[j]
            Hnew[j] = h
            if h > best:
                best, bi, bj = h, i - 1, j - 1
        H = Hnew
    return best, bi, bj


def sw_traceback_ref(
    scores: np.ndarray, go: float, ge: float
) -> Tuple[float, int, int, int, int, np.ndarray, np.ndarray]:
    """Full SW with traceback.

    Returns (score, qstart, qend, tstart, tend, q_idx, t_idx) where q_idx /
    t_idx are aligned index arrays with -1 denoting a gap position.
    """
    Lq, Lt = scores.shape
    H = np.zeros((Lq + 1, Lt + 1))
    E = np.full((Lq + 1, Lt + 1), NEG)
    F = np.full((Lq + 1, Lt + 1), NEG)
    jge = ge * np.arange(Lt + 1)
    for i in range(1, Lq + 1):
        F[i] = np.maximum(H[i - 1] - go, F[i - 1] - ge)
        diag = H[i - 1, :-1] + scores[i - 1]
        h0 = np.maximum(0.0, np.maximum(diag, F[i, 1:]))
        # E via prefix max of (h0 + k*ge); exact for go >= ge (gap opened
        # from an E-derived cell is dominated by extending that gap)
        G = np.empty(Lt + 1)
        G[0] = 0.0
        G[1:] = h0
        P = np.maximum.accumulate(G[:-1] + jge[:-1])
        Escan = P - go - jge[1:] + ge
        H[i, 1:] = np.maximum(h0, Escan)
        # store the Gotoh-consistent E (prefix max over the FINAL row) so
        # traceback identities (E == H[j-1]-go etc.) hold exactly
        P2 = np.maximum.accumulate(H[i, :-1] + jge[:-1])
        E[i, 1:] = P2 - go - jge[1:] + ge
    best_flat = np.argmax(H)
    bi, bj = np.unravel_index(best_flat, H.shape)
    score = H[bi, bj]

    # traceback
    qi, tj = int(bi), int(bj)
    q_idx, t_idx = [], []
    state = "H"
    while qi > 0 and tj > 0:
        h = H[qi, tj]
        if h == 0 and state == "H":
            break
        if state == "H":
            if h == E[qi, tj]:
                state = "E"
                continue
            if h == F[qi, tj]:
                state = "F"
                continue
            # diagonal
            q_idx.append(qi - 1)
            t_idx.append(tj - 1)
            qi -= 1
            tj -= 1
        elif state == "E":  # gap consuming target
            q_idx.append(-1)
            t_idx.append(tj - 1)
            if E[qi, tj] == H[qi, tj - 1] - go:
                state = "H"
            tj -= 1
        else:  # F: gap consuming query
            q_idx.append(qi - 1)
            t_idx.append(-1)
            if F[qi, tj] == H[qi - 1, tj] - go:
                state = "H"
            qi -= 1
    q_idx.reverse()
    t_idx.reverse()
    q_arr = np.array(q_idx, dtype=np.int32)
    t_arr = np.array(t_idx, dtype=np.int32)
    q_al = q_arr[q_arr >= 0]
    t_al = t_arr[t_arr >= 0]
    qstart = int(q_al[0]) if len(q_al) else 0
    qend = int(q_al[-1]) if len(q_al) else -1
    tstart = int(t_al[0]) if len(t_al) else 0
    tend = int(t_al[-1]) if len(t_al) else -1
    return float(score), qstart, qend, tstart, tend, q_arr, t_arr
