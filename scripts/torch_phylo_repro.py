#!/usr/bin/env python3
"""Repeat chip_smoke.py phase 3c's first CPU likelihood call in the state
that the phases before it leave, and count the repeats that differ.

    python3 scripts/torch_phylo_repro.py [--repeats N] [--max-differ K]
        [--skip PHASES] [--sweep-reps N] [--json FILE]

In one process, the work that ran before phase 3c when its check
failed: phase 5's CPU run started on every core but two (split_cores),
this process pinned to the other two, then phase 1 (the kernels' build),
2, 2b, 2c and 3b's checks (chip_smoke.py now runs 2c and 3b after 3d,
beside phase 5's CUDA run).  Then phase 3c's inputs (PHYLO: 20 taxa, 8,192
columns, NJ start, NNI neighbours and walks) and up to --repeats calls of
its first CPU call, `cpu.loglik_batch(cb[:8], bb[:8])` under
tf32_requested, each held against float64_loglik and against the first
clean result (every candidate within 1e-6 relative of float64).  A repeat
differs when a candidate is past 1e-6 of float64 or not bit-equal to the
clean result; the run stops after --max-differ such repeats.  Phase 5's
CPU run is stopped once the repeats end.

--skip takes a comma list of cpu-run, build, 2, 2b, 2c, 3b (build skips
2-3b too, which need the kernels): the bisection's cuts.  With build
skipped the script needs no card.

Each repeat logs the process state the CPU call depends on: the float32
matmul precision, oneDNN's matmul precision, torch's intra-op and
inter-op thread counts, and for every OpenMP worker of the intra-op pool
(read inside a parallel region of torch's own libgomp) its thread id, the
core it runs on and its MXCSR (rounding mode, FTZ, DAZ).  Every other
repeat runs under a TorchDispatchMode that records the precision, oneDNN's
precision and the thread count at every matrix product of the call.  A
differing repeat is computed again at the thread count and at one thread.
At the end, --sweep-reps calls with the whole pool pinned to each core in
turn.

Prints the card's name and power limit (nvidia-smi) beside the counts, a
line per differing repeat and a summary; --json writes the summary.
Exits 0 when no repeat differs, 1 when one does.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402

PHASES = ("cpu-run", "build", "2", "2b", "2c", "3b")
REL_LIMIT = 1e-6  # a candidate's lnL against float64_loglik
MATMULS = ("mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "matmul")


def process_state(team):
    import torch

    return dict(precision=torch.get_float32_matmul_precision(),
                mkldnn_matmul=torch.backends.mkldnn.matmul.fp32_precision,
                threads=torch.get_num_threads(), interop=torch.get_num_interop_threads(),
                workers=team.workers())


def op_logger():
    """A TorchDispatchMode that counts the matrix products it sees by
    (op, matmul precision, oneDNN matmul precision, threads)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name in MATMULS:
                self.seen[(name, torch.get_float32_matmul_precision(),
                           torch.backends.mkldnn.matmul.fp32_precision, torch.get_num_threads())] += 1
            return func(*args, **(kwargs or {}))

    return OpLog()


def phylo_inputs(dev, n, L):
    """phase_phylo's engines and candidates at n taxa x L columns: (cpu
    engine, card engine or None, cb, bb)."""
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.synthetic import simulate_msa

    P = dict(c.PHYLO, n=n, L=L)
    rng = np.random.RandomState(P["seed"])
    msa = simulate_msa(rng, P["n"], P["L"])
    cpu, gpu = c._phylo_pair(msa, P["model"], P["alpha"], P["p_inv"], dev or "cpu")
    cc, b = c._nj_start(msa, 1e-3)
    root = tl.arrays_to_tree(cc, b, cpu.names)
    trees = ts.nni_neighbors(root)
    while len(trees) < P["batch"]:
        trees.append(ts.random_nni_walk(root, rng, 3))
    arr = [tl.tree_to_arrays(x, cpu.names) for x in trees[:P["batch"]]]
    return cpu, gpu if dev else None, np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])


class CpuRuns:
    """Phase 5's CPU run on `cores`, started again each time it ends until
    stop(), so the repeats have it beside them throughout as phase 3c
    has; keeps each run's span on the script's clock."""

    def __init__(self, work, cores):
        self.work, self.cores, self.spans, self.error = work, cores, [], None
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        with ThreadPoolExecutor(1) as pool:
            i = 0
            while not c._STOPPED.is_set():
                t0 = c.clock()
                _, fut = c.start_crosscheck(os.path.join(self.work, f"cpu_run_{i}"), pool, self.cores)
                try:
                    _, t1 = fut.result()
                except BaseException as e:  # noqa: BLE001 - reported by stop()
                    if not c._STOPPED.is_set():
                        self.error = e
                    break
                self.spans.append((round(t0, 1), round(t1, 1)))
                i += 1

    def stop(self):
        c.stop_cli_runs()
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.spans


def earlier_phases(skip, work, fg, bg):
    """The work before phase 3c in its failing runs, less the phases in
    `skip`; returns (ctx or None, CpuRuns or None)."""
    runs = None if "cpu-run" in skip else CpuRuns(work, bg)
    os.sched_setaffinity(0, fg)
    if "build" in skip:
        return None, runs
    with c.span("phase 1"):
        ctx = c.phase_env()
    for name, fn in (("2", c.phase_exact), ("2b", c.phase_banded_exact), ("2c", c.phase_dirbits_exact),
                     ("3b", c.phase_nw)):
        if name not in skip:
            with c.span(f"phase {name}"):
                fn(ctx)
    return ctx, runs


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no card"


def host_lines():
    """The kernel and the first CPU's /proc/cpuinfo block but its flags."""
    first = open("/proc/cpuinfo").read().split("\n\n")[0].splitlines()
    return [open("/proc/version").read().strip()] + [line for line in first if not line.startswith("flags")]


def call(cpu, cb, bb, mode=None):
    k = c.PHYLO["cpu_batch"]
    with c.tf32_requested(), (mode or contextlib.nullcontext()):
        return np.asarray(cpu.loglik_batch(cb[:k], bb[:k]), np.float64)


def repeat(args, cpu, cb, bb, team):
    """The repeats, the first as phase 3c makes it (nothing read before
    it); returns the summary."""
    import torch

    k = c.PHYLO["cpu_batch"]
    t0 = time.perf_counter()
    first = call(cpu, cb, bb)
    times = [time.perf_counter() - t0]
    f64 = np.asarray(c.float64_loglik(cpu, cb[:k], bb[:k]))
    c.log(f"[repro] float64: {f64.tolist()}")
    clean, differ, per_cand, states = None, [], collections.Counter(), collections.Counter()
    ops_seen, worst = collections.Counter(), 0.0
    for r in range(args.repeats):
        state = None
        if r == 0:
            v = first
        else:
            state = process_state(team)
            states[json.dumps({k2: v2 for k2, v2 in state.items() if k2 != "workers"}, sort_keys=True)] += 1
            mode = op_logger() if r % 2 == 1 else None
            t0 = time.perf_counter()
            v = call(cpu, cb, bb, mode)
            times.append(time.perf_counter() - t0)
            if mode is not None:
                ops_seen.update(mode.seen)
        rel = np.abs(v - f64) / np.abs(f64)
        worst = max(worst, float(rel.max()))
        if clean is None and rel.max() <= REL_LIMIT:
            clean = v
        bad = [i for i in range(k) if rel[i] > REL_LIMIT or (clean is not None and v[i] != clean[i])]
        if not bad:
            continue
        per_cand.update(bad)
        after = process_state(team)
        again = call(cpu, cb, bb)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = call(cpu, cb, bb)
        finally:
            torch.set_num_threads(threads)
        rec = dict(repeat=r, candidates=bad, ops_logged=r % 2 == 1, state=state, state_after=after,
                   values=[float(v[i]) for i in bad], float64=[float(f64[i]) for i in bad],
                   again=[float(again[i]) for i in bad], one_thread=[float(one[i]) for i in bad],
                   rel=[float(rel[i]) for i in bad], clock=round(c.clock(), 1))
        differ.append(rec)
        c.log(f"[repro] repeat {r} differs in candidates {bad}: " + json.dumps(rec))
        if len(differ) >= args.max_differ:
            break
    return dict(repeats=len(times), differing=len(differ), candidates=dict(sorted(per_cand.items())),
                clean=None if clean is None else [float(x) for x in clean], float64=f64.tolist(),
                max_rel_err=worst, seconds_per_call=float(np.median(times)),
                states=dict(states), ops=[list(k2) + [n] for k2, n in sorted(ops_seen.items())],
                differ=differ), f64


def core_sweep(args, cpu, cb, bb, f64, team, cores):
    """--sweep-reps calls with the team pinned to each core in turn:
    {core: candidates past REL_LIMIT in any of them}."""
    out = {}
    try:
        for core in sorted(cores):
            team.pin({core})
            bad = set()
            for _ in range(args.sweep_reps):
                v = call(cpu, cb, bb)
                bad.update(np.flatnonzero(np.abs(v - f64) / np.abs(f64) > REL_LIMIT).tolist())
            out[core] = sorted(bad)
    finally:
        team.pin(cores)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--max-differ", type=int, default=3)
    ap.add_argument("--skip", default="", help="comma list of " + ", ".join(PHASES))
    ap.add_argument("--sweep-reps", type=int, default=1, help="calls per core at the end (0: none)")
    ap.add_argument("--taxa", type=int, default=c.PHYLO["n"], help="phase 3c's size (a smaller one for a CPU test)")
    ap.add_argument("--columns", type=int, default=c.PHYLO["L"])
    ap.add_argument("--json", help="write the summary here")
    args = ap.parse_args(argv)
    skip = {s for s in args.skip.split(",") if s}
    unknown = skip - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "build" in skip:
        skip |= {"2", "2b", "2c", "3b"}

    import torch

    if "build" not in skip and not torch.cuda.is_available():
        print("torch_phylo_repro: phases 1-3b need an NVIDIA GPU (skip them with --skip build)", file=sys.stderr)
        return 2
    c._CLOCK[0] = time.perf_counter()
    work = tempfile.mkdtemp(prefix="phylo_repro_")
    os.environ["HOME"] = os.path.join(work, "home_inproc")
    smi = card_line()
    c.log(smi)
    for line in host_lines():
        c.log(f"host: {line}")
    c.log(f"host: {c.host_cpu()}; torch {torch.__version__}; skipped: {sorted(skip) or 'nothing'}")
    fg, bg = c.split_cores()
    every_core = os.sched_getaffinity(0)
    runs = None
    try:
        ctx, runs = earlier_phases(skip, work, fg, bg)
        with c.span("phase 3c inputs"):
            cpu, _, cb, bb = phylo_inputs(ctx["dev"] if ctx else None, args.taxa, args.columns)
        team = c.OpenMPTeam()
        with c.span("repeats"):
            res, f64 = repeat(args, cpu, cb, bb, team)
        cpu_spans = runs.stop() if runs else []
        runs = None
        with c.span("core sweep"):
            res["core_sweep"] = core_sweep(args, cpu, cb, bb, f64, team, every_core) if args.sweep_reps else {}
    finally:
        if runs is not None:
            runs.stop()
        shutil.rmtree(work, ignore_errors=True)
        os.sched_setaffinity(0, every_core)
    res.update(card=smi, host=host_lines() + [c.host_cpu()], skipped=sorted(skip), torch=torch.__version__,
               cpu_runs=cpu_spans)
    c.log(f"[repro] {smi}: {res['differing']} of {res['repeats']} repeats differ (candidates "
          f"{res['candidates']}); {res['seconds_per_call']:.3f} s a call; largest error against float64 "
          f"{res['max_rel_err']:.3g}; states {res['states']}; products {res['ops']}; phase 5's CPU runs "
          f"beside them {cpu_spans}; core sweep {res['core_sweep']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "repeats", "differing", "candidates", "max_rel_err", "skipped")}))
    return 1 if res["differing"] else 0


if __name__ == "__main__":
    sys.exit(main())
