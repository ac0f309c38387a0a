"""Verbosity-gated logging.

Mirrors the reference's leveled printf scheme (util/message.rs:4-22,
envs/variables.rs:146-152): a process-global verbosity in [0..4]
(0 quiet, 1 +errors, 2 +warnings, 3 +info, 4 +debug); a message is shown
iff its level <= the global verbosity.
"""

from __future__ import annotations

import sys

_VERBOSITY = 3


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = max(0, min(4, int(level)))


def verbosity() -> int:
    return _VERBOSITY


def print_message(msg: str, level: int) -> None:
    """Print without newline (used for \r-rewritten progress counters)."""
    if level <= _VERBOSITY:
        print(msg, end="", flush=True)


def println_message(msg: str, level: int) -> None:
    if level <= _VERBOSITY:
        print(msg, flush=True)


def eprintln_message(msg: str, level: int) -> None:
    if level <= _VERBOSITY:
        print(msg, file=sys.stderr, flush=True)
