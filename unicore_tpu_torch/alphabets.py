"""Amino-acid and 3Di alphabets with integer encodings.

Encoding order for amino acids follows the conventional BLOSUM ordering
"ARNDCQEGHILKMFPSTWYV" + X (unknown/any).  The 3Di structural alphabet
(Foldseek) is the 20 lowercase-equivalent letters "ACDEFGHIKLMNPQRSTVWY"
used as states of a learned VQ codebook; we encode it with the same
letter set in uppercase + X.

Integer codes are stable across the whole framework: substitution
matrices, Pallas kernels, and MSA profiles all index with these codes.
"""

from __future__ import annotations

import numpy as np

AA_ALPHABET = "ARNDCQEGHILKMFPSTWYV"          # 20 canonical
AA_UNKNOWN = "X"
AA_FULL = AA_ALPHABET + AA_UNKNOWN            # code 20 = X/any
AA_SIZE = len(AA_FULL)                        # 21

# Foldseek 3Di state letters (A..Y without B,J,O,U,X,Z), X = unknown
TDI_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
TDI_UNKNOWN = "X"
TDI_FULL = TDI_ALPHABET + TDI_UNKNOWN
TDI_SIZE = len(TDI_FULL)                      # 21

_AA_LUT = np.full(128, AA_SIZE - 1, dtype=np.int8)
for i, c in enumerate(AA_FULL):
    _AA_LUT[ord(c)] = i
# common ambiguity codes -> nearest canonical or X
for amb, rep in {"B": "N", "Z": "Q", "J": "L", "U": "C", "O": "K", "*": "X", "-": "X"}.items():
    _AA_LUT[ord(amb)] = _AA_LUT[ord(rep)]
for i, c in enumerate(AA_FULL.lower()):
    _AA_LUT[ord(c)] = i

_TDI_LUT = np.full(128, TDI_SIZE - 1, dtype=np.int8)
for i, c in enumerate(TDI_FULL):
    _TDI_LUT[ord(c)] = i
for i, c in enumerate(TDI_FULL.lower()):
    _TDI_LUT[ord(c)] = i


def encode_aa(seq: str) -> np.ndarray:
    buf = np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8)
    return _AA_LUT[np.minimum(buf, 127)]


def encode_3di(seq: str) -> np.ndarray:
    buf = np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8)
    return _TDI_LUT[np.minimum(buf, 127)]


def decode_3di(codes: np.ndarray) -> str:
    return "".join(TDI_FULL[c] for c in codes)


def decode_aa(codes: np.ndarray) -> str:
    return "".join(AA_FULL[c] for c in codes)
