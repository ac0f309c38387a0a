#!/usr/bin/env python3
"""Time builds of the port's direction-bit DP kernel against each other on
one NVIDIA GPU.

    python3 scripts/torch_dirbits_bench.py [--source NAME=PATH ...] [--out FILE]

A source is a version of unicore_tpu_torch/csrc/dirbits.cu: an older
commit's file (its C interface without the columns argument is bound as
it is) or a copy with another table; "new" is always the shipped
file.  Every source is built with the wrapper's nvcc flags (ops/sw_cuda.py
NVCC_FLAGS).  The shipped file's register, shared-memory and spill counts
(nvcc -Xptxas -v) are printed first.

At chip_smoke.py's phase-3b batches (the MSA's NW forward: NW_TIMED, int32
scores as the merge pipeline packs them and int16 as nw_align_batch does,
gaps 2816/256) and phase-3d batches (the m8 traceback's SW forward:
SWB_TIMED, int16, gaps 100/10), every build is first held bit-identical to
the plain version (ops/nw_device.py, ops/sw_bits.py) on whole bits arrays
and (end_i, end_j, score), then timed in turns, forward then backward
(A B B A), each reading CUDA events around 20 back-to-back launches; a
build's time is the mean of its two readings.  Prints ms, us per row and
the share of chip_smoke.py's bound per batch and build, and writes them as
JSON lines to --out.  Exits 1 if any build disagrees with the plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20  # back-to-back launches per reading


def bind_any(so: Path) -> ctypes.CDLL:
    """A library of any version of dirbits.cu: the shipped interface, or an
    older one without C (no dirbits_forward_columns)."""
    from unicore_tpu_torch.ops import dirbits_cuda

    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "dirbits_forward_columns"):
        return dirbits_cuda.bind(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dirbits_forward_launch.argtypes = [P, I, P, P, I, I, I, I, I, I, P, P, P, P, P, P]
    lib.dirbits_forward_launch.restype = ctypes.c_int
    lib.dirbits_forward_scratch_ints.argtypes = [I, I]
    lib.dirbits_forward_scratch_ints.restype = ctypes.c_longlong
    return lib


def launch(lib, d, go, ge, local):
    """One launch of `lib` on (S, l1, l2) with the table's C; returns
    (bits, end_i, end_j, score)."""
    import torch

    S, l1, l2 = d
    B, L1, L2 = S.shape
    dev = S.device
    bits = torch.empty((B, L1, L2), dtype=torch.uint8, device=dev)
    ends = [torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(3)]
    new = hasattr(lib, "dirbits_forward_columns")
    n = lib.dirbits_forward_scratch_ints(B, L1, L2, 0) if new else lib.dirbits_forward_scratch_ints(B, L2)
    scratch = torch.empty((n,), dtype=torch.int32, device=dev) if n else None
    extra = (int(local), 0) if new else (int(local),)
    rc = lib.dirbits_forward_launch(
        S.data_ptr(), int(S.dtype == torch.int16), l1.data_ptr(), l2.data_ptr(), int(go), int(ge),
        B, L1, L2, *extra, bits.data_ptr(), *(x.data_ptr() for x in ends),
        None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"torch_dirbits_bench: launch failed, cudaError_t {rc}")
    return (bits, *ends)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dirbits_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from unicore_tpu_torch.ops import dirbits_cuda, nw_device, sw_bits, sw_cuda
    from unicore_tpu_torch.synthetic import nw_scores, sw_windows

    ctx = cs.phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sw_cuda._nvcc(), *sw_cuda.NVCC_FLAGS, "-Xptxas=-v",
                              "-o", os.path.join(tmp, "lib.so"), str(dirbits_cuda.SOURCE)],
                             capture_output=True, text=True)
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            cs.log("  ptxas:", line.strip())

    builds = {"new": dirbits_cuda.load()}
    specs = [spec.split("=", 1) for spec in opts.source]
    with ThreadPoolExecutor(max(1, len(specs))) as pool:  # one nvcc per source, started together
        libs = list(pool.map(lambda spec: sw_cuda.build_library(Path(spec[1])), specs))
    for (name, _), so in zip(specs, libs):
        builds[name] = bind_any(so)

    cases = [("nw", Lb, B, dtype) for Lb, B in cs.NW_TIMED for dtype in ("int32", "int16")]
    cases += [("sw_bits", Lb, B, "int16") for Lb, B in cs.SWB_TIMED]
    rows, bad = [], []
    for kind, Lb, B, dtype in cases:
        local = kind == "sw_bits"
        if local:
            S, l1, l2 = sw_windows(ctx["rng"], B, Lb, "rand")
        else:
            S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb, "rand")
        d = [torch.from_numpy(x).to(ctx["dev"]) for x in (S.astype(dtype), l1, l2)]
        go, ge = cs.SWB_GAPS[0] if local else cs.NW_GAPS[0]
        ref = (sw_bits.sw_forward_bits if local else nw_device.nw_forward_bits)(*d, go, ge)
        names = list(builds)
        for n in names:
            out = launch(builds[n], d, go, ge, local)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                bad.append((n, kind, B, Lb, dtype))
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(cs.time_cuda(lambda: launch(builds[n], d, go, ge, local), REPS))
        bound_ms = cs.dirbits_bound(ctx, d[0], kind)[0]
        for n in names:
            ms = sum(times[n]) / len(times[n])
            row = dict(build=n, kind=kind, B=B, L1=Lb, L2=Lb, dtype=dtype, ms=ms, readings=times[n],
                       us_per_row=1e3 * ms / Lb, bound_ms=bound_ms, share=bound_ms / ms, card=ctx["smi"])
            rows.append(row)
            cs.log(f"  {kind:7s} {B:3d} x {Lb:5d}^2 {dtype:5s} {n:8s} {ms:9.4f} ms {row['us_per_row']:7.4f} us/row "
                   f"{100 * row['share']:5.2f} % of bound  (readings " + ", ".join(f"{x:.4f}" for x in times[n])
                   + ")")
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    for n, kind, B, Lb, dtype in bad:
        cs.log(f"MISMATCH: build {n} disagrees with the plain version at {kind} {B} x {Lb}^2 {dtype}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
