"""Substitution matrices for AA and 3Di scoring.

* BLOSUM62 — standard NCBI values, order ARNDCQEGHILKMFPSTWYV + X.
* 3Di default — the reference delegates 3Di scoring to Foldseek's
  trained `mat3di` substitution matrix (cluster.rs:43-55 via foldseek;
  van Kempen et al. 2024, Nat Biotechnol 42:243-246).  The published
  matrix (foldseek `data/mat3di.out`, half-bit units, state order
  ACDEFGHIKLMNPQRSTVWY + X) is embedded below as MAT3DI and is the
  default, so cluster/search scores match foldseek's scoring model out
  of the box.  A matrix file via the UNICORE_TPU_3DI_MATRIX environment
  variable (standard NCBI/foldseek text format, `load_matrix_file`)
  still overrides it; `surrogate_3di_matrix` keeps the old
  parameterized match/mismatch stand-in available for experiments.

Combined structural score (Foldseek-style, gapped SW over 3Di(+AA)):
    s(i,j) = w_3di * S3di[q3di_i, t3di_j] + w_aa * Saa[qaa_i, taa_j]
with Foldseek's default weighting ~ (2.1 : 1.4) normalized here to 1.4/2.1.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from unicore_tpu_torch.alphabets import AA_FULL, AA_SIZE, TDI_FULL, TDI_SIZE

_BLOSUM62_ROWS = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""


def _blosum62() -> np.ndarray:
    m = np.full((AA_SIZE, AA_SIZE), -1, dtype=np.int32)
    rows = [r for r in _BLOSUM62_ROWS.strip().split("\n")]
    for i, row in enumerate(rows):
        vals = [int(x) for x in row.split()]
        m[i, :20] = vals
    m[20, :] = -1
    m[:, 20] = -1
    return m


BLOSUM62 = _blosum62()


# Foldseek's trained 3Di substitution matrix (mat3di.out, half-bit
# units).  Rows/cols in TDI_FULL order ACDEFGHIKLMNPQRSTVWY + X; the X
# row/column is 0 as in the published file.
_MAT3DI_ROWS = """
  6  -3   1   2   3  -2  -2  -7  -3  -3 -10  -5  -1   1  -4  -7   0  -5   2  -9
 -3   6  -2  -8  -5  -4  -4 -12 -13   1 -14   0   0  -8   1  -1  -8  -7  -7  -6
  1  -2   4  -3   0   1   1  -3  -5  -4  -5  -2   1  -4  -2  -4  -2  -3  -2  -4
  2  -8  -3   9  -2  -7  -4 -12 -10  -7 -17  -8  -6   5  -3 -10 -10 -13   0  -6
  3  -5   0  -2   7  -3  -3  -5   1  -3  -9  -5  -2  -5   2  -6   4  -4  -1  -7
 -2  -4   1  -7  -3   6   3  -2  -7  -7  -5  -2   3  -4  -4  -2  -4   0  -7  -4
 -2  -4   1  -4  -3   3   6  -1  -7  -6  -6  -3   1  -3  -5  -3  -5   1  -6  -3
 -7 -12  -3 -12  -5  -2  -1   8  -5 -11   7  -6  -4 -12  -9  -9  -8  -3 -10   0
 -3 -13  -5 -10   1  -7  -7  -5   9 -11  -8 -12  -6  -5   6  -9   5  -8  -9 -10
 -3   1  -4  -7  -3  -7  -6 -11 -11   6 -16  -3  -2  -4  -1  -1  -9 -10  -2  -5
-10 -14  -5 -17  -9  -5  -6   7  -8 -16  10  -9  -9 -15 -13 -14  -9  -5 -13  -8
 -5   0  -2  -8  -5  -2  -3  -6 -12  -3  -9   7   0  -7  -3   3  -8  -2  -8  -5
 -1   0   1  -6  -2   3   1  -4  -6  -2  -9   0   4  -4  -3   0  -4  -1  -5  -5
  1  -8  -4   5  -5  -4  -3 -12  -5  -4 -15  -7  -4   9   0 -10  -5 -12   3  -4
 -4   1  -2  -3   2  -4  -5  -9   6  -1 -13  -3  -3   0   7  -4   0  -8  -2  -7
 -7  -1  -4 -10  -6  -2  -3  -9  -9  -1 -14   3   0 -10  -4   6  -6  -4  -9  -9
  0  -8  -2 -10   4  -4  -5  -8   5  -9  -9  -8  -4  -5   0  -6   8  -9  -6  -9
 -5  -7  -3 -13  -4   0   1  -3  -8 -10  -5  -2  -1 -12  -8  -4  -9   9 -10  -5
  2  -7  -2   0  -1  -7  -6 -10  -9  -2 -13  -8  -5   3  -2  -9  -6 -10   8  -6
 -9  -6  -4  -6  -7  -4  -3   0 -10  -5  -8  -5  -5  -4  -7  -9  -9  -5  -6   9
"""


def _mat3di() -> np.ndarray:
    m = np.zeros((TDI_SIZE, TDI_SIZE), dtype=np.int32)
    rows = _MAT3DI_ROWS.strip().split("\n")
    for i, row in enumerate(rows):
        m[i, :20] = [int(x) for x in row.split()]
    assert np.array_equal(m, m.T), "mat3di must be symmetric"
    return m


MAT3DI = _mat3di()

def implied_background(S: np.ndarray) -> np.ndarray:
    """The background frequencies under which an integer log-odds matrix
    is Karlin-Altschul consistent (the Yu-Altschul inverse problem).

    A valid log-odds matrix satisfies sum_j p_j e^{lambda s_ij} = 1 for
    every i at its natural lambda; solving p = M(lambda)^{-1} 1 and
    root-finding lambda on sum(p) = 1 recovers (lambda, p).  For the
    embedded mat3di this yields lambda = 0.3227 (published ungapped
    lambda 0.3516 — the gap is integer-rounding, same magnitude as
    BLOSUM62's 0.3176 vs ln2/2) and an all-positive background with
    E[score] = -3.33.  Real 3Di backgrounds are skewed and
    anti-correlated with the diagonal; a UNIFORM null puts the scoring
    system in the linear phase (chance scores grow linearly with
    length), so every chance model in the engine (E-value calibration,
    composition-bias background term) must use this background.
    Falls back to uniform if no consistent solution exists."""
    S = np.asarray(S, dtype=np.float64)[:20, :20]

    def psum(lam: float) -> float:
        try:
            return float(np.linalg.solve(np.exp(lam * S), np.ones(20)).sum()) - 1.0
        except np.linalg.LinAlgError:
            return np.nan

    lo, hi = 0.05, 1.5
    grid = np.linspace(lo, hi, 60)
    vals = [psum(g) for g in grid]
    root = None
    for a, b, fa, fb in zip(grid[:-1], grid[1:], vals[:-1], vals[1:]):
        if np.isfinite(fa) and np.isfinite(fb) and fa > 0 >= fb:
            from scipy.optimize import brentq
            root = brentq(psum, a, b)
            break
    if root is None:
        return np.full(20, 0.05)
    p = np.linalg.solve(np.exp(root * S), np.ones(20))
    if (p <= 0).any():
        return np.full(20, 0.05)
    return p / p.sum()


MAT3DI_BG = implied_background(MAT3DI)

_BG_CACHE: dict = {}


def get_3di_background() -> np.ndarray:
    """(20,) 3Di state background for null models: the implied
    background of whatever 3Di matrix is in effect (env overrides get
    their own consistent background automatically)."""
    override = os.environ.get("UNICORE_TPU_3DI_MATRIX")
    if override and os.path.isfile(override):
        if override not in _BG_CACHE:
            _BG_CACHE[override] = implied_background(get_3di_matrix())
        return _BG_CACHE[override].copy()
    return MAT3DI_BG.copy()


def default_3di_matrix() -> np.ndarray:
    """The trained foldseek mat3di (the scoring parity default)."""
    return MAT3DI.copy()


def surrogate_3di_matrix(match: int = 6, mismatch: int = -3, unknown: int = -1) -> np.ndarray:
    """Parameterized match/mismatch stand-in (pre-round-4 default)."""
    m = np.full((TDI_SIZE, TDI_SIZE), mismatch, dtype=np.int32)
    np.fill_diagonal(m, match)
    m[TDI_SIZE - 1, :] = unknown
    m[:, TDI_SIZE - 1] = unknown
    return m


def load_matrix_file(path: str, alphabet: str) -> np.ndarray:
    """Parse an NCBI/foldseek-format substitution matrix text file."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    header = lines[0].split()
    col_idx: Dict[str, int] = {}
    size = len(alphabet)
    m = np.zeros((size, size), dtype=np.int32)
    for j, c in enumerate(header):
        col_idx[c.upper()] = j
    pos = {c: i for i, c in enumerate(alphabet)}
    for ln in lines[1:]:
        parts = ln.split()
        row_letter = parts[0].upper()
        if row_letter not in pos:
            continue
        i = pos[row_letter]
        for c, j in col_idx.items():
            if c in pos and j + 1 < len(parts) + 1:
                m[i, pos[c]] = int(round(float(parts[j + 1])))
    return m


def get_3di_matrix() -> np.ndarray:
    override = os.environ.get("UNICORE_TPU_3DI_MATRIX")
    if override and os.path.isfile(override):
        return load_matrix_file(override, TDI_FULL)
    return default_3di_matrix()


def get_aa_matrix() -> np.ndarray:
    override = os.environ.get("UNICORE_TPU_AA_MATRIX")
    if override and os.path.isfile(override):
        return load_matrix_file(override, AA_FULL)
    return BLOSUM62


# Foldseek-style combined weighting: the combined score is the weighted
# MEAN 0.4*aa + 0.6*3di (gap 10/1), expressed x10 in small integer units
# (weights 4 : 6, gaps 100/10 — NOT the 28/3 sum-mapping of rounds 1-3,
# which put gapped chance scores in the linear phase) so every combined
# cell score is a small integer — exact under bf16 MXU arithmetic and in
# bf16 score storage (see ops/sw.py "Gap units" note)
W_3DI = 6.0
W_AA = 4.0


def combined_matrix(w_3di: float = W_3DI, w_aa: float = W_AA) -> Optional[np.ndarray]:
    """Joint (21*21 x 21*21) matrix over (aa, 3di) pairs, float32.

    Index = aa_code * TDI_SIZE + tdi_code.  Used to fold both channels
    into one MXU-friendly score lookup.
    """
    aa = get_aa_matrix().astype(np.float32)
    tdi = get_3di_matrix().astype(np.float32)
    joint = (
        w_aa * np.repeat(np.repeat(aa, TDI_SIZE, 0), TDI_SIZE, 1)
        + w_3di * np.tile(np.tile(tdi, (AA_SIZE, 1)), (1, AA_SIZE))
    )
    return joint.astype(np.float32)
