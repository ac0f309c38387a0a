#!/usr/bin/env python3
"""Probe int16 arithmetic on one NVIDIA Hopper card: the port's counterpart
of scripts/probe_i16.py.

    python3 scripts/torch_probe_i16.py [--json FILE]

Each probe is one kernel, unicore_tpu_torch/csrc/probe_i16.cu built with
-DPROBE_OP=k by its own nvcc run (ops/sw_cuda.py's build_library and
NVCC_FLAGS, into build/), and launched in a process of its own, so that a
build or a launch that fails takes only its own probe down.  The builds
start together, then the launches.  PROBES holds the seven operations of
scripts/probe_i16.py with the same meaning on 16 x 128 int16, and the
packed int16x2 forms: the first five, and every further form the int16 SW
instance (csrc/sw.cu, sw_i16_kernel) uses.  Each runs on two
input sets, x ones and y twos as in the JAX probe, and a seeded random set
that reaches +-32767 so that wrapping shows, and is held against numpy's
wrapping int16 arithmetic (`reference`).

Prints one line per probe, OK, WRONG (with the first differing element) or
CRASH (with the last line of the error), then "k/N int16 ops compile and
match".  Exits 0 only if all N pass; 2, saying which is missing, when there
is no nvcc or no card.  --json writes each probe's status, its largest
difference from numpy, its kernel's time (CUDA events over a run of
launches) beside numpy's on the host, and the bytes it must move; and for
each packed form its issue rate, the warp-instructions an SM issues a cycle
on independent chains (probe_i16.cu's rate_kernel, clock64), printed
beside its status: the rate chip_smoke.py's int16 bound counts at.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "unicore_tpu_torch", "csrc", "probe_i16.cu")
SHAPE = (16, 128)
SEED = 16
REPS = 100  # timed launches per probe

def halves(x):
    """(lo, hi) halves of the packed words: elements 2k and 2k + 1."""
    p = x.reshape(-1, 2)
    return p[:, 0], p[:, 1]


def words(lo, hi):
    """int16 elements from the words' (lo, hi) halves."""
    return np.stack([lo, hi], axis=1).reshape(SHAPE)


def perm(x, y, sel):
    """__byte_perm(x, y, sel) on the words, for selectors that move whole
    halves: nibble pairs (1, 0) -> x's lo, (3, 2) -> x's hi, (5, 4) -> y's
    lo, (7, 6) -> y's hi."""
    src = dict(zip((0x10, 0x32, 0x54, 0x76), (*halves(x), *halves(y))))
    return words(src[sel & 0xff], src[sel >> 8])


# name -> the operation on int16 arrays x, y, z, as numpy computes it (int16
# arithmetic wraps); the order is the source's PROBE_OP
PROBES = {
    "i16_max": lambda x, y, z: np.maximum(x, y),
    "i16_sub": lambda x, y, z: x - y,
    "i16_add": lambda x, y, z: x + y,
    "i16_roll": lambda x, y, z: np.roll(x, 1, axis=1),
    "i16_select": lambda x, y, z: np.where(x > 0, x, y),
    "i16_cast_from_i32": lambda x, y, z: (x.astype(np.int32) + 1).astype(np.int16),
    "i16_cmp_to_sel_i16": lambda x, y, z: np.where(x > y, np.int16(1), np.int16(0)) + x,
    "vmaxs2": lambda x, y, z: np.maximum(x, y),
    "vadd2": lambda x, y, z: x + y,
    "vsub2": lambda x, y, z: x - y,
    "viaddmax_s16x2": lambda x, y, z: np.maximum(x + y, z),
    "vimax3_s16x2": lambda x, y, z: np.maximum(np.maximum(x, y), z),
    "viaddmax_s16x2_relu": lambda x, y, z: np.maximum(np.maximum(x + y, z), np.int16(0)),
    "vmins2": lambda x, y, z: np.minimum(x, y),
    "viaddmax_s16x2_none": lambda x, y, z: x + y,
    "byte_perm_rot": lambda x, y, z: perm(x, y, 0x1054),
    "byte_perm_hi2lo": lambda x, y, z: perm(x, y, 0x7632),
    "byte_perm_los": lambda x, y, z: perm(x, y, 0x5410),
    "byte_perm_swap": lambda x, y, z: perm(x, y, 0x1032),
    "viaddmin_s16x2_relu": lambda x, y, z: np.maximum(np.minimum(x + y, z), np.int16(0)),
}
# operands each probe reads (the others read x and y)
OPERANDS = {"i16_roll": 1, "i16_cast_from_i32": 1, "viaddmax_s16x2": 3, "vimax3_s16x2": 3,
            "viaddmax_s16x2_relu": 3, "byte_perm_swap": 1, "viaddmin_s16x2_relu": 3}


def inputs():
    """{set name: (x, y, z)}: ones and twos (z a small ramp), and a seeded
    random set over the whole int16 range with its extremes planted."""
    n = SHAPE[0] * SHAPE[1]
    ramp = (np.arange(n) % 7 - 3).astype(np.int16).reshape(SHAPE)
    sets = {"ones_twos": (np.ones(SHAPE, np.int16), np.full(SHAPE, 2, np.int16), ramp)}
    rng = np.random.RandomState(SEED)
    x, y, z = (rng.randint(-32768, 32768, SHAPE).astype(np.int16) for _ in range(3))
    edge = np.array([32767, -32768, 32767, -32768, 32767, -32767, 1, -1], np.int16)
    x[0, :8], y[0, :8], z[0, :8] = edge, edge[::-1], edge
    x[1, :8], y[1, :8] = edge, np.int16(1)
    sets["random"] = (x, y, z)
    return sets


def reference(name, x, y, z):
    return np.asarray(PROBES[name](x, y, z), dtype=np.int16)


def bytes_moved(name):
    """Bytes probe `name` must move: each operand read once, o written once."""
    return (OPERANDS.get(name, 2) + 1) * SHAPE[0] * SHAPE[1] * 2


def missing():
    """The reasons this machine cannot run the probes (empty if none)."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda

    why = []
    try:
        sw_cuda._nvcc()
    except RuntimeError as e:
        why.append(f"no nvcc: {e}")

    if not torch.cuda.is_available():
        why.append("no card: torch.cuda.is_available() is False")
    return why


def build(k):
    """Path of probe k's library, or the exception its build raised."""
    from pathlib import Path

    from unicore_tpu_torch.ops import sw_cuda

    try:
        return sw_cuda.build_library(Path(SOURCE), sw_cuda.NVCC_FLAGS + (f"-DPROBE_OP={k}",))
    except Exception as e:  # a failed build is this probe's CRASH
        return e


def child(so):
    """In the probe's own process: run it on every input set and print the
    results (hex) and the time of one launch."""
    lib = ctypes.CDLL(so)
    lib.probe_i16_run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.probe_i16_run.restype = ctypes.c_int
    for set_name, (x, y, z) in inputs().items():
        out = np.zeros(SHAPE, np.int16)
        ms = ctypes.c_float(0.0)
        rc = lib.probe_i16_run(x.ctypes.data, y.ctypes.data, z.ctypes.data, out.ctypes.data,
                               REPS, ctypes.byref(ms))
        if rc != 0:
            print(f"cudaError_t {rc} on {set_name}", file=sys.stderr)
            return 1
        print(f"RESULT {set_name} {out.tobytes().hex()}")
        print(f"MS {set_name} {ms.value!r}")
    rate = ctypes.c_float(0.0)
    lib.probe_i16_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_i16_rate.restype = ctypes.c_int
    rc = lib.probe_i16_rate(inputs()["random"][0].ctypes.data, ctypes.byref(rate))
    if rc != 0:
        print(f"cudaError_t {rc} measuring the issue rate", file=sys.stderr)
        return 1
    print(f"RATE all {rate.value!r}")
    return 0


def launch(name, so):
    """Run probe `name` from library `so` in a process of its own and
    check it: (status, detail, kernel ms, max |result - numpy|, the packed
    form's warp-instructions an SM a cycle or None)."""
    if isinstance(so, Exception):
        return "CRASH", (str(so).strip().splitlines() or [""])[-1][:160], None, None, None
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(so)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return "CRASH", (r.stderr.strip().splitlines() or [f"exit code {r.returncode}"])[-1][:160], None, None, None
    got, ms, rate = {}, [], None
    for line in r.stdout.splitlines():
        tag, set_name, val = line.split()
        if tag == "RESULT":
            got[set_name] = np.frombuffer(bytes.fromhex(val), np.int16).reshape(SHAPE)
        elif tag == "MS":
            ms.append(float(val))
        elif tag == "RATE" and float(val) >= 0:
            rate = float(val)
    err, wrong = 0, ""
    for set_name, (x, y, z) in inputs().items():
        want = reference(name, x, y, z)
        if set_name not in got:
            return "CRASH", f"no result on {set_name}", None, None, None
        diff = np.abs(got[set_name].astype(np.int32) - want)
        err = max(err, int(diff.max()))
        if err and not wrong:
            r_, c_ = np.argwhere(diff > 0)[0]
            wrong = (f"{set_name}[{r_},{c_}]: x={x[r_, c_]} y={y[r_, c_]} z={z[r_, c_]} "
                     f"-> {got[set_name][r_, c_]}, numpy {want[r_, c_]}")
    return ("WRONG" if err else "OK"), wrong, max(ms), err, rate


def numpy_ms(name, reps=1000):
    """ms of one numpy evaluation of probe `name` on the random set."""
    x, y, z = inputs()["random"]
    t0 = time.perf_counter()
    for _ in range(reps):
        reference(name, x, y, z)
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write each probe's status and times here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.child:
        return child(opts.child)
    sys.path.insert(0, ROOT)
    why = missing()
    if why:
        for w in why:
            print(f"torch_probe_i16: {w}", file=sys.stderr)
        print("torch_probe_i16: nothing was run", file=sys.stderr)
        return 2
    names = list(PROBES)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build, range(len(names))))
        results = list(pool.map(launch, names, libs))
    ok = 0
    rows = []
    for name, (status, detail, ms, err, rate) in zip(names, results):
        ok += status == "OK"
        issue = f"  {rate:.2f} warp-instructions an SM a cycle" if rate is not None else ""
        print(f"{name:22s} {status:5s}  {detail}{issue}", flush=True)
        rows.append(dict(name=name, status=status, detail=detail, ms=ms, max_abs_err=err,
                         numpy_ms=numpy_ms(name), bytes=bytes_moved(name), issue_rate=rate))
    print(f"{ok}/{len(names)} int16 ops compile and match", flush=True)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump({"probes": rows, "passed": ok, "total": len(names)}, f, indent=1)
    return 0 if ok == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
