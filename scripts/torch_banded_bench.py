#!/usr/bin/env python3
"""Time builds of the port's banded Smith-Waterman kernel against each
other on one NVIDIA GPU.

    python3 scripts/torch_banded_bench.py [--source NAME=PATH ...] [--out FILE]

A source is a version of unicore_tpu_torch/csrc/banded.cu: an older
commit's file (its C interface without the columns argument is bound as
it is) or a copy with another table; "new" is always the shipped file.
Every source is built with the wrapper's nvcc flags (ops/sw_cuda.py
NVCC_FLAGS).  The shipped file's register, shared-memory and spill counts
(nvcc -Xptxas -v) are printed first.

For each of chip_smoke.py's phase-3e batches (BANDED_ENGINE: planted long
pairs, bias on) and each engine mode (gapped with gap_window 64,
ungapped), every build is first held bit-exact against the plain version
(ops/banded.py), then timed in turns, forward then backward (A B B A),
each reading CUDA events around 20 back-to-back launches; a build's time
is the mean of its two readings.  Prints ms, us per row and the share of
chip_smoke.py's bound per batch, mode and build, and writes them as JSON
lines to --out.  Exits 1 if any build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 20  # back-to-back launches per reading


def bind_any(so: Path) -> ctypes.CDLL:
    """A library of any version of banded.cu: the shipped interface, or an
    older one without C (no banded_forward_columns)."""
    from unicore_tpu_torch.ops import banded_cuda

    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "banded_forward_columns"):
        return banded_cuda.bind(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.banded_forward_launch.argtypes = [P] * 10 + [F] * 4 + [I] * 6 + [P] * 4
    lib.banded_forward_launch.restype = ctypes.c_int
    return lib


def launch(lib, t, saa, s3d, W, gap_window, ungapped):
    """One launch of `lib` on the inputs t (qa qs ta ts qlen tlen d0 qc) with
    the engine's gaps and weights; returns (best, qend, tend)."""
    import torch

    from unicore_tpu_torch.align.engine import AlignParams

    p = AlignParams()
    B, Lq = t[0].shape
    Lt = t[2].shape[1]
    out = (torch.empty(B, dtype=torch.float32, device=t[0].device),
           torch.empty(B, dtype=torch.int32, device=t[0].device),
           torch.empty(B, dtype=torch.int32, device=t[0].device))
    columns = (0,) if hasattr(lib, "banded_forward_columns") else ()
    rc = lib.banded_forward_launch(
        *(x.data_ptr() for x in t), saa.data_ptr(), s3d.data_ptr(),
        float(p.gap_open), float(p.gap_extend), float(p.w_aa), float(p.w_3di),
        B, Lq, Lt, W, gap_window, int(ungapped), *columns,
        *(x.data_ptr() for x in out), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"torch_banded_bench: launch failed, cudaError_t {rc}")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_banded_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from unicore_tpu_torch.align.engine import AlignParams
    from unicore_tpu_torch.ops import banded_cuda, sw_cuda
    from unicore_tpu_torch.ops.banded import sw_forward_banded

    ctx = cs.phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sw_cuda._nvcc(), *sw_cuda.NVCC_FLAGS, "-Xptxas=-v",
                              "-o", os.path.join(tmp, "lib.so"), str(banded_cuda.SOURCE)],
                             capture_output=True, text=True)
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            cs.log("  ptxas:", line.strip())

    builds = {"new": banded_cuda.load()}
    for spec in opts.source:
        name, path = spec.split("=", 1)
        builds[name] = bind_any(sw_cuda.build_library(Path(path)))

    p = AlignParams()
    saa, s3d = ctx["saa"], ctx["s3d"]
    rows, bad = [], []
    for B, Lq, Lt, W in cs.BANDED_ENGINE:
        t = cs.band_pairs_on(cs._band_pairs(ctx["rng"], B, Lq, Lt), ctx["dev"])
        for kind, kw in cs.TIMED_MODES.items():
            gw, ug = kw.get("gap_window", 0), kw.get("ungapped", False)
            ref = sw_forward_banded(*t[:7], saa, s3d, W=W, go=p.gap_open, ge=p.gap_extend, w_aa=p.w_aa,
                                    w_3di=p.w_3di, qc=t[7], **kw)
            names = list(builds)
            for n in names:
                out = launch(builds[n], t, saa, s3d, W, gw, ug)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    bad.append((n, B, Lq, Lt, W, kind))
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(cs.time_cuda(lambda: launch(builds[n], t, saa, s3d, W, gw, ug), REPS))
            bound_ms = cs.banded_bound(ctx, t, W, kind)[0]
            for n in names:
                ms = sum(times[n]) / len(times[n])
                row = dict(build=n, B=B, Lq=Lq, Lt=Lt, W=W, mode=kind, ms=ms, readings=times[n],
                           us_per_row=1e3 * ms / Lq, bound_ms=bound_ms, share=bound_ms / ms, card=ctx["smi"])
                rows.append(row)
                cs.log(f"  {B:3d} {Lq:5d} {Lt:5d} {W:5d} {kind:8s} {n:8s} {ms:9.4f} ms {row['us_per_row']:7.4f} us/row "
                       f"{100 * row['share']:5.2f} % of bound  (readings " + ", ".join(f"{x:.4f}" for x in times[n])
                       + ")")
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    for n, B, Lq, Lt, W, kind in bad:
        cs.log(f"MISMATCH: build {n} disagrees with the plain version at {(B, Lq, Lt, W)} {kind}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
