#!/usr/bin/env python3
"""Time builds of the port's Smith-Waterman kernel against each other on
one NVIDIA GPU.

    python3 scripts/torch_sw_bench.py [--source NAME=PATH ...] [--dp-dtype f32|i16]
                                      [--shapes 512:512,512:1024] [--sweep] [--out FILE]

A source is a version of unicore_tpu_torch/csrc/sw.cu with the same C
interface (an older commit's file, or a copy with another dispatch table
or mapping); "new" is always the shipped file.  Every source is built with
the wrapper's nvcc flags (ops/sw_cuda.py NVCC_FLAGS), and every build's
register and spill counts (nvcc -Xptxas -v) are printed first.

--dp-dtype f32 (the default) times the float32 kernel at chip_smoke.py's
phase-3 inputs (SHAPES: ragged lengths, planted homologies, bias on);
--dp-dtype i16 its int16 instance at chip_smoke.py's I16_SHAPES (B, L, go,
ge) on the same kind of inputs, with chip_smoke.py's int16 bound.  For
each shape and mode (gapped with gap_window 64, ungapped), every build is
first held bit-exact against the plain version (ops/sw.py, the plain int16
DP with i16), then timed in turns, forward then backward (A B C C B A),
each reading chip_smoke.py's time_cuda around 50 back-to-back launches; a
build's time is the mean of its two readings.  With i16, --sweep adds one
build per words-a-lane count of SWEEP_WORDS: a copy of the shipped file
under build/sw_sweep/ whose int16 table (dispatch_i16) gives that count at
every width (words_source), timed beside the others at each shape where
it takes at most 8 warps a pair.  Prints ms, GCUPS and the share of the
bound per shape, mode and build, and writes them as JSON lines to --out.
Exits 1 if any build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REPS = 50  # back-to-back launches per reading
SWEEP_WORDS = (2, 4, 8)  # --sweep: the int16 instance's words a lane; a warp holds 64 columns a word
MAX_PAIR_WARPS = 8  # csrc/sw.cu


def words_source(src: Path, words: int, out_dir: Path) -> Path:
    """A copy of `src` whose int16 table gives `words` words a lane at every
    width (one warp a pair up to 64 * words columns); returns its path."""
    text = src.read_text()
    head = "template <bool BIAS>\ncudaError_t dispatch_i16("
    body = re.search(re.escape(head) + r".*?\n\}\n", text, re.S)
    if body is None:
        raise SystemExit(f"{src}: no dispatch_i16 to replace")
    lines = [head + "const I16Args& a, bool ungapped, cudaStream_t st) {",
             f"  if ((a.Lt + {64 * words - 1}) / {64 * words} > MAX_PAIR_WARPS) return cudaErrorInvalidValue;"]
    for ug in ("true", "false"):
        call = (f"a.Lt <= {64 * words} ? launch_i16_mode<{words}, {ug}, BIAS, false>(a, st) "
                f": launch_i16_mode<{words}, {ug}, BIAS, true>(a, st)")
        lines.append(f"  if (ungapped) return {call};" if ug == "true" else f"  return {call};")
    out = out_dir / f"sw_words{words}.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text(text[:body.start()] + "\n".join(lines) + "\n}\n" + text[body.end():])
    return out


def ptxas(name: str, path: str, nvcc: str, flags) -> None:
    """Print the register and spill counts of every kernel in one build."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([nvcc, *flags, "-Xptxas=-v", "-o", os.path.join(tmp, "lib.so"), str(path)],
                             capture_output=True, text=True)
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            cs.log(f"  ptxas [{name}]:", line.strip())


def in_turns(calls: dict, reps: int) -> dict:
    """{name: [reading, reading]}: each call timed forward then backward."""
    times = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        times[n].append(cs.time_cuda(calls[n], reps))
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--dp-dtype", default="f32", choices=("f32", "i16"))
    ap.add_argument("--shapes", default=None, help="B:L,... (i16: B:L:go:ge,...)")
    ap.add_argument("--sweep", action="store_true", help="i16: a build per words-a-lane count")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sw_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import (
        GAP_EXTEND_INT, GAP_OPEN_INT, W_3DI_INT, W_AA_INT, sw_forward_plain,
    )

    i16 = opts.dp_dtype == "i16"
    ctx = cs.phase_env()
    sources = {"new": sw_cuda.SOURCE}
    for spec in opts.source:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
    if i16 and opts.sweep:
        for words in SWEEP_WORDS:
            sources[f"words{words}"] = words_source(sw_cuda.SOURCE, words, sw_cuda.BUILD_DIR.parent / "sw_sweep")
    with ThreadPoolExecutor(2 * len(sources)) as pool:  # one nvcc a build, all started together
        counts = [pool.submit(ptxas, name, path, sw_cuda._nvcc(), sw_cuda.NVCC_FLAGS)
                  for name, path in sources.items()]
        libs = {name: pool.submit(sw_cuda.build_library, path) for name, path in list(sources.items())[1:]}
        builds = {"new": sw_cuda.load()}
        builds.update({name: sw_cuda.bind(f.result()) for name, f in libs.items()})
        for f in counts:
            f.result()

    if opts.shapes:
        shapes = [tuple(float(x) if k >= 2 else int(x) for k, x in enumerate(s.split(":")))
                  for s in opts.shapes.split(",")]
    else:
        shapes = list(cs.I16_SHAPES) if i16 else list(cs.SHAPES)
    saa, s3d = ctx["saa"], ctx["s3d"]
    rows, bad = [], []
    for shape in shapes:
        B, L = shape[:2]
        go, ge = shape[2:] if i16 else (GAP_OPEN_INT, GAP_EXTEND_INT)
        args, qc = cs.sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
        cells = cs.cells_of(args)
        for kind, kw in cs.TIMED_MODES.items():
            gw, ug = kw.get("gap_window", 0), kw.get("ungapped", False)

            def call(lib):
                return sw_cuda.launch_with(lib, *args, saa, s3d, go, ge, W_AA_INT, W_3DI_INT, gw, ug, qc,
                                           opts.dp_dtype)

            ref = sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype=opts.dp_dtype, **kw)
            calls = {n: (lambda lib=lib: call(lib)) for n, lib in builds.items()
                     if not n.startswith("words") or -(-L // (64 * int(n[5:]))) <= MAX_PAIR_WARPS}
            for n, fn in calls.items():
                out = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    bad.append((n, B, L, kind))
            times = in_turns(calls, REPS)
            if i16:
                bound_ms = cs.i16_bound(ctx, args, qc, kind)[0]
            else:
                bound_ms = cs.bound_of(ctx, args, qc, kind)[0]
            for n in calls:
                ms = sum(times[n]) / len(times[n])
                row = dict(build=n, dp_dtype=opts.dp_dtype, B=B, L=L, go=go, ge=ge, mode=kind, ms=ms,
                           readings=times[n], gcups=cells / ms / 1e6, bound_ms=bound_ms,
                           share=bound_ms / ms, device=ctx["smi"])
                rows.append(row)
                cs.log(f"  {opts.dp_dtype} {B:4d} {L:5d} {kind:8s} {n:10s} {ms:9.4f} ms {row['gcups']:7.1f} "
                       f"GCUPS {100 * row['share']:5.1f} % of bound  (readings "
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
