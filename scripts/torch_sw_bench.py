#!/usr/bin/env python3
"""Time builds of the port's Smith-Waterman kernel against each other on
one NVIDIA GPU.

    python3 scripts/torch_sw_bench.py [--source NAME=PATH ...]
                                      [--shapes 512:512,512:1024] [--out FILE]

A source is a version of unicore_tpu_torch/csrc/sw.cu with the same C
interface (an older commit's file, or a copy with another dispatch table
or mapping); "new" is always the shipped file.  Every source is built with
the wrapper's nvcc flags (ops/sw_cuda.py NVCC_FLAGS).  The shipped file's
register and spill counts (nvcc -Xptxas -v) are printed first.

For each shape (chip_smoke.py's phase-3 inputs: ragged lengths, planted
homologies, bias on) and mode (gapped with gap_window 64, ungapped), every
build is first held bit-exact against the plain version (ops/sw.py), then
timed in turns, forward then backward (A B C C B A), each reading CUDA
events around 50 back-to-back launches; a build's time is the mean of its
two readings.  Prints ms, GCUPS and the share of chip_smoke.py's bound per
shape, mode and build, and writes them as JSON lines to --out.  Exits 1 if
any build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 50  # back-to-back launches per reading


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", default=",".join(f"{B}:{L}" for B, L in cs.SHAPES))
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sw_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import (
        GAP_EXTEND_INT, GAP_OPEN_INT, W_3DI_INT, W_AA_INT, sw_forward_plain,
    )

    ctx = cs.phase_env()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sw_cuda._nvcc(), *sw_cuda.NVCC_FLAGS, "-Xptxas=-v",
                              "-o", os.path.join(tmp, "lib.so"), str(sw_cuda.SOURCE)],
                             capture_output=True, text=True)
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            cs.log("  ptxas:", line.strip())

    builds = {"new": sw_cuda.load()}
    for spec in opts.source:
        name, path = spec.split("=", 1)
        builds[name] = sw_cuda.bind(sw_cuda.build_library(Path(path)))

    saa, s3d = ctx["saa"], ctx["s3d"]
    rows, bad = [], []
    for shape in opts.shapes.split(","):
        B, L = (int(x) for x in shape.split(":"))
        args, qc = cs.sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
        cells = cs.cells_of(args)
        for kind, kw in cs.TIMED_MODES.items():
            gw, ug = kw.get("gap_window", 0), kw.get("ungapped", False)

            def call(lib):
                return sw_cuda.launch_with(lib, *args, saa, s3d, GAP_OPEN_INT, GAP_EXTEND_INT,
                                           W_AA_INT, W_3DI_INT, gw, ug, qc)

            ref = sw_forward_plain(*args, saa, s3d, qc=qc, **kw)
            names = list(builds)
            for n in names:
                out = call(builds[n])
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    bad.append((n, B, L, kind))
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(cs.time_cuda(lambda: call(builds[n]), REPS))
            bound_ms = cs.bound_of(ctx, args, qc, kind)[0]
            for n in names:
                ms = sum(times[n]) / len(times[n])
                row = dict(build=n, B=B, L=L, mode=kind, ms=ms, readings=times[n],
                           gcups=cells / ms / 1e6, bound_ms=bound_ms, share=bound_ms / ms)
                rows.append(row)
                cs.log(f"  {B:4d} {L:5d} {kind:8s} {n:10s} {ms:9.4f} ms {row['gcups']:7.1f} GCUPS "
                       f"{100 * row['share']:5.1f} % of bound  (readings "
                       + ", ".join(f"{t:.4f}" for t in times[n]) + ")")
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    for n, B, L, kind in bad:
        cs.log(f"MISMATCH: build {n} disagrees with the plain version at B={B} L={L} {kind}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
