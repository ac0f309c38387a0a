"""Predictor interface: AA sequences -> equal-length 3Di strings.

This is the contract of `foldseek createdb --prostt5-model`
(createdb.rs:158-166): every amino-acid sequence is translated into a
3Di structural-alphabet string of identical length.
"""

from __future__ import annotations

from typing import List, Protocol


class ThreeDiPredictor(Protocol):
    def predict(self, sequences: List[str]) -> List[str]:
        """Return one 3Di string per input AA sequence, same lengths."""
        ...
