"""The device trace of the measured window, and what is read from it.

`profiler()` traces the window with shapes and Python frames; `record`
turns the profiler's raw events into a compact trace:

  window  [start, end] of the harness's call spans (µs, trace clock)
  calls   [[start, end], ...] one span per call into the program
  frames  [[label, start, end], ...] Python frames of the program and
          the harness ("prostt5.py:_attention")
  ops     [[name, shapes, dtypes, chain], ...] each CPU op that launched
          device work, with the indices of the frames it ran in,
          outermost first
  device  [[name, start, end, op], ...] every kernel, copy and fill, with
          the index of the op that launched it (-1: none found)

A kernel is tied to its op through the profiler's correlation ids, and
an op to its frames by time: a frame (a PyCall node of the profiler's
event tree) holds an op that starts inside it.
Times are µs from the first call's start.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

CALL_SPAN = "port_bench.call"
# CUPTI's overhead records: no work of the device, though the trace files
# them with the device's events, and no op, though it gives them an op's
# correlation id
OVERHEAD = {"Unknown", "Driver Compiler", "Buffer Flush", "Instrumentation", "Resource",
            "Runtime Triggered Module Loading", "Lazy Function Loading", "Command Buffer Full",
            "Activity Buffer Request", "UVM Activity Init"}
PROGRAM_FILES = re.compile(r"(^|/)(unicore_tpu_torch|port_bench)/")
PY_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=True, with_stack=True)


def call_span():
    import torch

    return torch.profiler.record_function(CALL_SPAN)


def frame_label(name: str) -> Optional[str]:
    """"file.py:func" of a Python frame event of the program or the
    harness, else None."""
    m = PY_FRAME.match(name)
    if not m or not PROGRAM_FILES.search(m.group(1)):
        return None
    return f"{m.group(1).rsplit('/', 1)[-1]}:{m.group(3)}"


def _is_python(e) -> bool:
    f = getattr(e, "is_python_function", None)
    return bool(f()) if f is not None else bool(PY_FRAME.match(e.name()))


def _frames(result) -> List[Tuple[int, int, str]]:
    """(start, end, label) ns of the program's and the harness's Python
    frames: the PyCall nodes of the profiler's event tree."""
    out, todo = [], list(result.experimental_event_tree())
    while todo:
        e = todo.pop()
        todo.extend(e.children)
        if str(e.tag).endswith(".PyCall"):
            label = frame_label(e.name)
            if label is not None:
                out.append((e.start_time_ns, e.end_time_ns, label))
    return out


def record(prof) -> Dict:
    """The compact trace of a `profiler()` run.  Device events that no op
    launched (the call spans' own device-side copies) are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    result = prof.profiler.kineto_results
    ops, dev, calls = {}, [], []
    for e in result.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.linked_correlation_id() > 0:
                dev.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id()))
        elif name == CALL_SPAN:
            calls.append((e.start_ns(), e.end_ns()))
        elif e.linked_correlation_id() == 0 and name not in OVERHEAD and not _is_python(e):
            ops[e.correlation_id()] = (e.start_ns(), name, [list(x) for x in e.shapes()], list(e.dtypes()))
    return compact(_frames(result), ops, dev, calls)


def compact(frames, ops, dev, calls) -> Dict:
    """The compact trace of raw (ns) frames (start, end, label), ops
    {correlation: (start, name, shapes, dtypes)}, device events (start,
    end, name, linked correlation) and call spans (start, end); CUPTI's
    overhead records are left out."""
    dev = [d for d in dev if d[2] not in OVERHEAD]
    if not calls:
        raise ValueError("the trace holds no call span")
    calls.sort()
    t0 = calls[0][0]
    us = lambda ns: (ns - t0) / 1e3  # noqa: E731
    frames.sort(key=lambda f: (f[0], -f[1]))
    used = {c for *_, c in dev}
    op_list = sorted((v[0], c) for c, v in ops.items() if c in used)
    chains, stack, fi = {}, [], 0
    for start, corr in op_list:
        while fi < len(frames) and frames[fi][0] <= start:
            while stack and frames[stack[-1]][1] <= frames[fi][0]:
                stack.pop()
            stack.append(fi)
            fi += 1
        while stack and frames[stack[-1]][1] <= start:
            stack.pop()
        chains[corr] = list(stack)
    index = {corr: i for i, (_, corr) in enumerate(op_list)}
    return {
        "window": [0.0, us(max(t for _, t in calls))],
        "calls": [[us(s), us(t)] for s, t in calls],
        "frames": [[label, us(s), us(t)] for s, t, label in frames],
        "ops": [[ops[c][1], ops[c][2], ops[c][3], chains[c]] for _, c in op_list],
        "device": [[name, us(s), us(t), index.get(c, -1)] for s, t, name, c in sorted(dev)],
    }


def busy_intervals(tr: Dict) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, clipped to the window."""
    w0, w1 = tr["window"]
    out: List[List[float]] = []
    for _, s, t, _ in sorted(tr["device"], key=lambda d: d[1]):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(tr: Dict) -> float:
    return sum(t - s for s, t in busy_intervals(tr)) / 1e6


def window_s(tr: Dict) -> float:
    return (tr["window"][1] - tr["window"][0]) / 1e6


def func(label: str) -> str:
    return label.rsplit(":", 1)[-1]


def op_funcs(tr: Dict, op: int) -> List[str]:
    """Function names of the frames op `op` ran in, outermost first."""
    if op < 0:
        return []
    return [func(tr["frames"][i][0]) for i in tr["ops"][op][3]]


def device_time_by(tr: Dict, key) -> Dict:
    """{key(op index): µs of device time} over the device events, with
    `key` returning None for events to leave out."""
    out: Dict = {}
    for _, s, t, op in tr["device"]:
        k = key(op)
        if k is not None:
            out[k] = out.get(k, 0.0) + (t - s)
    return out


def _segments(tr: Dict) -> Tuple[List[float], List[Tuple[float, float, str]]]:
    """The timeline cut into spans of the innermost program frame."""
    ev = []
    for i, (_, s, t) in enumerate(tr["frames"]):
        ev.append((s, 1, i))
        ev.append((t, 0, i))
    ev.sort()
    segs, stack, last = [], [], None
    for t, kind, i in ev:
        if stack and last is not None and t > last:
            segs.append((last, t, tr["frames"][stack[-1]][0]))
        if kind == 1:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    return [s for s, _, _ in segs], segs


def idle_gaps(tr: Dict) -> List[Tuple[str, float, int]]:
    """(host frame, idle seconds, gaps) for the device's idle gaps inside
    the window, each gap charged to the innermost program frame that ran
    longest in it, most idle time first."""
    w0, w1 = tr["window"]
    busy = busy_intervals(tr)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    starts, segs = _segments(tr)
    total: Dict[str, List[float]] = {}
    for g0, g1 in gaps:
        over: Dict[str, float] = {}
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            s, t, label = segs[i]
            o = min(t, g1) - max(s, g0)
            if o > 0:
                over[label] = over.get(label, 0.0) + o
            i += 1
        label = max(over, key=over.get) if over else "no program frame"
        acc = total.setdefault(label, [0.0, 0])
        acc[0] += (g1 - g0) / 1e6
        acc[1] += 1
    return sorted(((k, v[0], v[1]) for k, v in total.items()), key=lambda x: -x[1])


def op_key(tr: Dict, op: int, name: str) -> str:
    """"aten op@innermost program function" of a device event."""
    if op < 0:
        return name[:80]
    fs = op_funcs(tr, op)
    return f"{tr['ops'][op][0]}@{fs[-1] if fs else '?'}"


def breakdown(tr: Dict, top: int = 10) -> Dict[str, List[Sequence]]:
    """The device operations that took most time and the idle time by
    what the host was doing, `top` of each, in seconds."""
    ops: Dict[str, float] = {}
    for name, s, t, op in tr["device"]:
        k = op_key(tr, op, name)
        ops[k] = ops.get(k, 0.0) + (t - s) / 1e6
    dev = sorted(ops.items(), key=lambda x: -x[1])[:top]
    gaps = [[f"{label} ({n} gaps)", sec] for label, sec, n in idle_gaps(tr)[:top]]
    return {"device_ops": [[k, v] for k, v in dev], "idle_gaps": gaps}
