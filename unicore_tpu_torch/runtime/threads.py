"""Global thread-count knob (host-side parallelism).

Mirrors envs/variables.rs:154-169: 0 means "all CPUs", values above the
system CPU count are clamped.  On the TPU path this controls host-side
data loading / featurization pools; device parallelism comes from the mesh.
"""

from __future__ import annotations

import os

_THREADS = 0


def set_threads(n: int) -> None:
    global _THREADS
    ncpu = os.cpu_count() or 1
    if n <= 0 or n > ncpu:
        _THREADS = ncpu
    else:
        _THREADS = n


def threads() -> int:
    if _THREADS == 0:
        set_threads(0)
    return _THREADS
