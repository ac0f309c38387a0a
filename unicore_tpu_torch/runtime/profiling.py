"""Per-stage tracing & performance counters.

Counterpart of unicore_tpu/runtime/profiling.py: wall-clock per pipeline
stage, cell counters for the alignment engine (`align.cells`,
`rescore.cells`, `*.seconds`), and optional device traces
(UNICORE_TPU_TORCH_TRACE_DIR=/path writes one `torch.profiler` Chrome
trace per stage into that directory).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

from . import logging as msg

_COUNTERS: Dict[str, float] = {}


def add_counter(name: str, value: float) -> None:
    _COUNTERS[name] = _COUNTERS.get(name, 0.0) + value


def set_counter(name: str, value: float) -> None:
    _COUNTERS[name] = value


def get_counters() -> Dict[str, float]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage; optionally capture a torch.profiler trace."""
    trace_dir = os.environ.get("UNICORE_TPU_TORCH_TRACE_DIR")
    prof = None
    if trace_dir:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    t0 = time.time()
    with prof if prof is not None else contextlib.nullcontext():
        yield
    dt = time.time() - t0
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    add_counter(f"stage.{name}.seconds", dt)
    msg.println_message(f"[{name}] {dt:.2f}s", 4)


def dump(path: str, extra: Dict[str, float]) -> None:
    """Write the counters (and `extra`) to `path` as one JSON object."""
    with open(path, "w") as f:
        json.dump({**_COUNTERS, **extra}, f, sort_keys=True)
