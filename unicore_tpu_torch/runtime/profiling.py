"""Per-stage tracing, spans & performance counters.

Counterpart of unicore_tpu/runtime/profiling.py: wall-clock per pipeline
stage, cell counters for the alignment engine (`align.cells`,
`rescore.cells`, `*.seconds`), spans inside the engines, and optional
device traces (UNICORE_TPU_TORCH_TRACE_DIR=/path writes one
`torch.profiler` Chrome trace per stage into that directory).

A span (`span(name)`) marks one phase of the program.  It records only
while a torch profiler records (a stage's trace, a benchmark's traced
window).  It then enters a record function of that name (torch's
`_RecordFunctionFast`, `torch.profiler.record_function` less its Python
calls), so the phase sits in the profiler's trace on the clock of the
kernels it launched, and adds its host seconds to `<name>.seconds` and
one to `<name>.calls`.  A device span (`device=True`) on a CUDA card
also records a pair of timing events on the current stream, taken from
a reused pool; `read_device_spans()`, called where the program knows
them ended (after a synchronisation it makes anyway), adds their elapsed
time to `<name>.device_seconds`.  No span synchronises.  While no
profiler records, `span` returns one shared context that does nothing:
one flag check, no clock read, no allocation.  Spans are small classes,
not generators, so that the profiler never takes a span's own code for
the frame that launched an op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from . import logging as msg

_COUNTERS: Dict[str, float] = {}
_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}  # (stream id, device, type) -> its Stream
_FREE_EVENTS: List["torch.cuda.Event"] = []  # timing events ready for reuse
# (counter, start, end) of device spans recorded and not yet read
_PENDING: List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]] = []


def add_counter(name: str, value: float) -> None:
    _COUNTERS[name] = _COUNTERS.get(name, 0.0) + value


def set_counter(name: str, value: float) -> None:
    _COUNTERS[name] = value


def get_counters() -> Dict[str, float]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def _recording() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _event() -> "torch.cuda.Event":
    return _FREE_EVENTS.pop() if _FREE_EVENTS else torch.cuda.Event(enable_timing=True)


def _record(event: "torch.cuda.Event") -> None:
    """Record `event` on the current stream of the current device
    (`torch.cuda.current_stream()`, whose Python calls a traced span would
    pay on every event)."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1], device_type=key[2])
    event.record(stream)


class _Off:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    """A span that records: see the module's docstring."""

    __slots__ = ("name", "start", "rf", "t0", "seconds")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.start = _event() if device else None
        self.seconds = 0.0

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if self.start is not None:
            _record(self.start)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.t0
        if self.start is not None:
            end = _event()
            _record(end)
            _PENDING.append((self.name + ".device_seconds", self.start, end))
        self.rf.__exit__(*exc)
        add_counter(self.name + ".seconds", self.seconds)
        add_counter(self.name + ".calls", 1)


def span(name: str, device: bool = False):
    """A context marking the phase `name`; `device`: the phase's work
    runs on the current CUDA device, and is timed on its clock too (not
    where torch sees no card)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device and torch.cuda.is_available())


class DeviceGap:
    """The device-clock time between the device spans of one series (the
    batches of one call, say), from the end of each to the start of the
    next, added to `<name>.device_seconds` once read.  Call `after`
    right after a span of the series exits and `before` right before the
    next one enters: nothing is queued on the stream between a span's
    event and the mark beside it, so both read the same time.  Records
    only while a profiler records."""

    __slots__ = ("counter", "start")

    def __init__(self, name: str):
        self.counter = name + ".device_seconds"
        self.start = None

    def after(self, device: bool) -> None:
        if device and _recording() and torch.cuda.is_available():
            self.start = _event()
            _record(self.start)

    def before(self) -> None:
        if self.start is not None:
            end = _event()
            _record(end)
            _PENDING.append((self.counter, self.start, end))
            self.start = None


def read_device_spans() -> None:
    """Add the elapsed time of each recorded device span whose end has
    passed on the device to its counter, and pool its events.  It reads
    in the order the spans ended on the host and stops at the first one
    still running (on one stream, those after it are too): it never
    waits, and a span left is read by a later call."""
    n = 0
    for counter, start, end in _PENDING:
        if not end.query():
            break
        add_counter(counter, start.elapsed_time(end) / 1e3)
        _FREE_EVENTS.extend((start, end))
        n += 1
    del _PENDING[:n]


class stage:
    """Time a pipeline stage as the span `stage.<name>`, recorded whether
    or not a profiler records (`stage.<name>.seconds`, `.calls`).  With
    UNICORE_TPU_TORCH_TRACE_DIR, a stage that no profiler records yet
    writes its own `torch.profiler` trace `<name>.json` there; a stage
    inside it shows in that trace as its span."""

    def __init__(self, name: str):
        self.name = name
        self.prof = None
        self.span = _Span(f"stage.{name}")

    def __enter__(self):
        self.trace_dir = os.environ.get("UNICORE_TPU_TORCH_TRACE_DIR")
        if self.trace_dir and not _recording():
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.span.__exit__(*exc)
        if self.prof is not None:
            self.prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.trace_dir, f"{self.name}.json"))
        msg.println_message(f"[{self.name}] {self.span.seconds:.2f}s", 4)


def dump(path: str, extra: Dict[str, float]) -> None:
    """Write the counters (and `extra`) to `path` as one JSON object."""
    with open(path, "w") as f:
        json.dump({**_COUNTERS, **extra}, f, sort_keys=True)
