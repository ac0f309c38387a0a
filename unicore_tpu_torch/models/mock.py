"""Deterministic mock 3Di predictor (test backend).

Without network egress the real ProstT5 weights cannot be downloaded, so
tests and offline runs use this deterministic surrogate.  It is built to
reproduce the two statistical properties of real 3Di strings that the
downstream pipeline (SW scoring under the trained mat3di, coverage
gates, E-value calibration, clustering) depends on:

  1. *Structure is more conserved than sequence.*  Real remote homologs
     keep ~40-60% 3Di identity at ~30% AA identity; a mock whose
     letters flip faster than AA (e.g. a raw-trigram hash, ~3 flips per
     substitution) makes distant orthologs look structurally unrelated
     under mat3di's harsh mismatch scores.  Here the letter at position
     i is a function of ROBUST sequence features — the Dayhoff group of
     a_i (AGPST/C/DENQ/HKR/ILMV/FWY; conserved by most evolutionary
     substitutions) plus one parity bit from each neighbor's group — so
     a substitution flips < 1 3Di position on average.
  2. *The 3Di channel must stay decorrelated from raw AA composition
     for unrelated pairs* (real 3Di is an independent structural
     signal; the E-value null model assumes quasi-independent
     channels).  A pure composition-level map (e.g. group(a_i) alone)
     turns the 3Di score into a redundant amplifier of weak AA
     similarity and over-merges unrelated proteins — measured on the
     3-proteome fixture it collapsed 79 clusters into 14.  The
     neighbor-parity bits hash in enough local context that unrelated
     sequences agree only at chance (~7%) while homologs retain the
     conservation in (1).

The (group, parity-bits) classes map onto the 20 3Di states through a
greedy max-similarity path through MAT3DI, with a group's four
parity variants path-ADJACENT: the most common perturbation (a
neighbor's parity flip) lands on a structurally-similar state with a
mild score, while a center-group change jumps blocks and scores like a
real structural change.  Identical local contexts map to identical
letters, so the mock is fully reproducible across hosts and backends.

Selected with model == "mock" or UNICORE_TPU_MOCK_PROSTT5=1.
"""

from __future__ import annotations

from typing import List

import numpy as np

from unicore_tpu_torch.alphabets import AA_ALPHABET, AA_SIZE, TDI_ALPHABET, encode_aa
from unicore_tpu_torch.matrices import MAT3DI


def _similarity_path() -> np.ndarray:
    """Greedy max-similarity Hamiltonian path through the 20 3Di states
    (deterministic): consecutive path states score highly against each
    other under MAT3DI, so parity-bit confusions are cheap."""
    n = len(TDI_ALPHABET)
    sim = MAT3DI[:n, :n].astype(np.int64)
    start = int(np.argmax(np.diag(sim)))  # highest self-similarity state
    path = [start]
    left = set(range(n)) - {start}
    while left:
        last = path[-1]
        nxt = max(sorted(left), key=lambda j: (sim[last, j], -j))
        path.append(nxt)
        left.remove(nxt)
    return np.array(path, dtype=np.int8)


_PATH = _similarity_path()

# Dayhoff groups over the AA codes (ARNDCQEGHILKMFPSTWYV + X)
_DAYHOFF = {
    "AGPST": 0, "C": 1, "DENQ": 2, "HKR": 3, "ILMV": 4, "FWY": 5,
}
_GROUP = np.zeros(AA_SIZE, dtype=np.int64)
for letters, g in _DAYHOFF.items():
    for c in letters:
        _GROUP[AA_ALPHABET.index(c)] = g
_GROUP[AA_SIZE - 1] = 0  # X -> largest group

# (group, 2 neighbor-parity bits) -> 3Di state.  Real 3Di backgrounds
# are anti-correlated with the diagonal (the ~22%-frequency state has a
# LOW self-score; rare states carry the high diagonals — that is what
# keeps the log-odds system in the logarithmic phase).  Mimic that:
# groups ordered by real-proteome frequency get path-adjacent quadruples
# ordered by ascending mean diagonal, so common mock states are cheap to
# match by chance and rare ones expensive — matching the E-value null.
_GROUP_BY_FREQ = [0, 4, 2, 3, 5, 1]  # AGPST > ILMV > DENQ > HKR > FWY > C
_QUADS = sorted(
    (list(range(4 * q, 4 * q + 4)) for q in range(5)),
    key=lambda r: sum(int(MAT3DI[_PATH[i], _PATH[i]]) for i in r),
)
_STATE = np.zeros((6, 4), dtype=np.int8)
for _rank, _g in enumerate(_GROUP_BY_FREQ):
    _quad = _QUADS[min(_rank, len(_QUADS) - 1)]  # C shares the last quad
    for _b, _i in enumerate(_quad):
        _STATE[_g, _b] = _PATH[_i]


class MockProstT5:
    name = "mock-prostt5"

    def predict(self, sequences: List[str]) -> List[str]:
        out = []
        tdi = np.frombuffer(TDI_ALPHABET.encode(), dtype=np.uint8)
        for seq in sequences:
            a = encode_aa(seq).astype(np.int64)
            if len(a) == 0:
                out.append("")
                continue
            g = _GROUP[a]
            gl = np.concatenate([g[:1], g[:-1]])   # left neighbor (edge-replicated)
            gr = np.concatenate([g[1:], g[-1:]])   # right neighbor
            b = 2 * (gl & 1) + (gr & 1)
            codes = _STATE[g, b]
            out.append(tdi[codes].tobytes().decode())
        return out
