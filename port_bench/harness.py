"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration's file, `traffic/<traffic>.json`, the configuration's
`drivers/<driver>.py` and one `metrics/<name>.py` for each per-layer
metric.  A driver is a module with a `Driver(cfg, traffic, seed,
device)` class:

  setup(seconds)        builds the program and warms it up; returns the
                        set-up's split [(name, seconds), ...]
  call(i)               the inputs of the window's call i
  run(inputs)           one call into the program; returns its outputs
  end_to_end(calls, s)  {metric: value} of the window's (inputs, outputs)
                        over s seconds
  layer_context(calls)  what the metric readers need of the calls
  counters()            the program's counters
  release()             frees the program's state
  check(calls)          {"attempted", "failed", "compared": [(name,
                        value, limit), ...], "correct"}

A metric reader is a module with `read(run) -> float | None`, where
`run` is a `Run`; None leaves the metric out of the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "port_bench")
BANNED = ("jax", "jaxlib", "flax", "unicore_tpu")


class Forbidden(RuntimeError):
    """A module the benchmark must not load was loaded."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(spec: Dict, workload: str):
    """(cell, configuration, traffic) of a workload, read from their files."""
    cell = find(spec["workloads"], workload, "workload")
    entry = find(spec["configs"], cell["config"], "config")
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return cell, cfg, traffic


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def metrics_of(spec: Dict, workload: str, kind: str) -> List[Dict]:
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


class Run:
    """What a per-layer metric reader reads: the configuration, the
    program's counters over the window, the window's length on the host
    clock, the device trace (or None) with its peaks, and the driver's
    `layer_context`."""

    def __init__(self, cfg, counters, window_s, trace, peaks, context):
        self.cfg, self.counters, self.window_s = cfg, counters, window_s
        self.trace, self.peaks, self.context = trace, peaks, context
        self.notes: List[str] = []

    def note(self, text: str) -> None:
        self.notes.append(text)


def counter_delta(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) if not k.endswith("peak_bytes") else v for k, v in after.items()}


def run_cell(spec: Dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, cfg: Optional[Dict] = None, traffic: Optional[Dict] = None):
    """The result of one run, the numbers compared last under "compared";
    `cfg` and `traffic` stand in for the cell's files where given (the
    CPU tests' tiny sizes)."""
    import torch

    from port_bench import counts, devtrace

    cell, cfg_f, traffic_f = cell_files(spec, workload)
    cfg, traffic = cfg or cfg_f, traffic or traffic_f
    driver_mod = load_module(os.path.join(HERE, "drivers", cfg["driver"] + ".py"),
                             "port_bench_driver_" + cfg["driver"])
    drv = driver_mod.Driver(cfg, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    log(f"[setup] import and device init {time.perf_counter() - t_start:.3f} s")
    for name, sec in drv.setup(seconds):
        log(f"[setup] {name} {sec:.3f} s")
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] total {setup_s:.3f} s")

    before = drv.counters()
    prof = devtrace.profiler() if trace else None
    calls = []
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        inputs = drv.call(len(calls))
        c0 = time.perf_counter()
        with devtrace.call_span():
            outputs = drv.run(inputs)
        sync()
        c1 = time.perf_counter()
        calls.append((inputs, outputs))
        log(f"[window] call {len(calls)} {c1 - c0:.3f} s")
        if c1 - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    counters = counter_delta(before, drv.counters())
    e2e = drv.end_to_end(calls, window)
    log(f"[window] {len(calls)} calls in {window:.3f} s: "
        + ", ".join(f"{k} {v:.6g}" for k, v in e2e.items()))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]) if cuda else 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    tr = None
    if prof is not None:
        t = time.perf_counter()
        tr = devtrace.record(prof)
        del prof
        if cuda:
            dev["busy_s"] = devtrace.busy_s(tr)
            dev["window_s"] = devtrace.window_s(tr)
        log(f"[trace] {len(tr['device'])} device events, {len(tr['ops'])} ops, "
            f"{len(tr['frames'])} frames, read in {time.perf_counter() - t:.3f} s")
    context = drv.layer_context(calls)
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics: Dict[str, Dict] = {}
    if trace:
        run = Run(cfg, counters, window, tr, counts.peaks(dev["kind"]), context)
        for m in metrics_of(spec, workload, "per_layer"):
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"), "port_bench_metric")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for text in run.notes:
            log(f"[metric] {text}")
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in metrics_of(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t = time.perf_counter()
    chk = drv.check(calls)
    log(f"[check] {time.perf_counter() - t:.3f} s")
    result = {"correct": bool(chk["correct"]), "attempted": int(chk["attempted"]),
              "failed": int(chk["failed"]), "metrics": metrics, "device": dev}
    if tr is not None and cuda:
        result["breakdown"] = devtrace.breakdown(tr)
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in chk["compared"]}
    banned = banned_modules()
    if banned:
        raise Forbidden(f"modules the benchmark must not load: {', '.join(banned)}")
    return result
