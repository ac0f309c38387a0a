"""Per-stage sentinel checkpoint files.

Mirrors util/checkpoint.rs:2-10: `{dir}/{stage}.chk` holding "0"
(stage started) or "1" (stage done). Easy workflows consult these to skip
completed stages on resume (workflow/easy_core.rs:28-93).
"""

from __future__ import annotations

import os


def write_checkpoint(path: str, value: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(value)


def read_checkpoint(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def is_done(path: str) -> bool:
    try:
        return read_checkpoint(path) == "1"
    except FileNotFoundError:
        return False
