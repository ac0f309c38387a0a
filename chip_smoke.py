#!/usr/bin/env python3
"""Smoke run of unicore_tpu_torch on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in order; the run stops with a non-zero exit at the first
failure, and no phase is skipped:

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the time to build the Smith-Waterman kernel (csrc/sw.cu) from the
   sources of this checkout.
2. Kernel vs plain version on the card, bit-exact on (best, qend, tend):
   gapped with gap_window 64 and 0, and ungapped; bias off, on and at
   exactly +-bias_clip_bound; gaps 100/10 and 28/3; (B, L) in (512, 128),
   (512, 256), (512, 512), (512, 1024), (192, 512) and (48, 2048), with
   ragged lengths and planted homologies.  Then the edges of the kernel's
   mapping (EDGE_SHAPES, B x Lt <= 64 x 4,096, Lq != Lt): every case of
   synthetic.sw_edge_pairs (lengths of 1, ties, a gap bonus, a bias past
   2^24, ...) and windows 0, 1, 2, 3, 48, 64, 100, Lt, 2*Lt and ungapped,
   half of them on each shape, alternating.
3. Times per shape and mode (CUDA events around a run of back-to-back
   launches, divided by their number, after a warm-up): kernel ms and
   GCUPS, the plain version's ms on the card, the bound, and the kernel's
   share of the bound.
   bound_ms = max(ops / peak scalar rate, bytes / memory rate), with
   ops = sum(qlen * tlen) * ops per cell, counted from the recurrence:
   gapped 14 (score 3, H0 3, F 3, E 3, H 1, best 1), ungapped 6 (score 3,
   H 2, best 1), one more for the bias add; peak scalar rate = SMs x 128
   FP32 lanes x the card's maximum SM clock (both read from the card);
   bytes = every input read once and every output written once, over
   3.35 TB/s (H100 SXM HBM3).  No single PyTorch call computes SW, so
   library_ms is null.
3b. The MSA's NW forward (ops/nw_device.py, PyTorch ops) on the card
   against the same function on the CPU, bit-identical on (bits, end_i,
   end_j, score): buckets 64, 512 and 2,048, batches of 1 and 64, gaps
   2816/256 (random scores) and 1100/100 (all-zero or constant scores:
   ties everywhere; not at 2,048 x 64), ragged lengths down to 1.  Then its time per dispatch at the merge pipeline's
   full batches (64 pairs at bucket 512, 16 at 2,048), and the device's
   busy time inside one dispatch from a torch.profiler trace; the fused
   merge's count products (64 x 512 x 512) and the guide gram (2,048 x
   8,192 bags), each equal to its CPU result, and their times.
4. The main path end to end at a real size: 20 synthetic proteomes x 120
   proteins (2,400 sequences, under the 5,000-sequence cascade
   threshold), gene families evolved along a random species tree with
   substitutions and indels, some families missing or duplicated in some
   species, lengths lognormal (median 300, clipped to 50-2,000).
   `createdb mock`, `cluster`, `profile` and `tree -n` (foldmason) run as
   `python -m unicore_tpu_torch` subprocesses with a fresh HOME (so the
   E-value calibration runs on the kernel).  Prints the stage times, the
   pipeline and MSA counts and the kernel's launches in that run; requires
   both modes launched, a cluster purity against the generating families
   of at least PURITY_FLOOR, a filtered MSA for every core gene whose rows
   ungapped are the gene's input sequences, and a supermatrix with one row
   per species whose partitions tile its width.
5. Cross-check: `easy-core -n`, then `tree -n -A mafft` and
   `tree -n -A mafft-linsi` on its outputs, on 3 species x 40 proteins
   (one family longer than 1,024: the banded path and the 2,048 NW
   bucket), on CUDA and on the CPU (UNICORE_TPU_TORCH_DEVICE=cpu), each
   with its own HOME; every file written must be byte-identical.

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel mode: launches in phase 4, times and bound at (512, 512), the
main path's most common bucket); the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits non-zero before
printing any result.  Nothing here imports JAX or unicore_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(512, 128), (512, 256), (512, 512), (512, 1024), (192, 512), (48, 2048)]
MODES = {"gapped_w64": dict(gap_window=64), "gapped_w0": dict(gap_window=0),
         "ungapped": dict(ungapped=True)}
GAPS = [(100.0, 10.0), (28.0, 3.0)]
TIMED_MODES = {"gapped": dict(gap_window=64), "ungapped": dict(ungapped=True)}  # the engine's
OPS_PER_CELL = {"gapped": 14, "ungapped": 6}  # +1 with the bias add
LANES_PER_SM = 128      # FP32 lanes of a Hopper SM
HBM_BYTES_PER_S = 3.35e12
KERNEL_SHAPE = (512, 512)
# (B, Lq, Lt) at the edges of the kernel's mapping: a lane, a warp of 32*C
# columns (C = 4, 8, 16) and one past it, 2 to 8 warps per pair
EDGE_SHAPES = [(13, 100, 1), (5, 64, 31), (13, 40, 33), (64, 80, 65), (5, 300, 129),
               (13, 200, 257), (5, 600, 511), (13, 400, 513), (5, 700, 1025),
               (13, 1500, 2048), (8, 500, 4096)]
EDGE_WINDOWS = [0, 1, 2, 3, 48, 64, 100]
# Share of clustered sequences in their family's majority cluster.  Not 1:
# the E-value null is simulated from the published 3Di background, which
# the mock 3Di backend does not follow, so a few chance hits between
# unrelated families pass the gate and merge clusters.  On a 489-sequence
# subset of 8 x 480 data from write_proteomes (tests/torch_purity_reading.py,
# on the CPU) the JAX package and the port both reach 0.9939 with identical
# clust.tsv, and 1.0 once the null's 3Di is made by the mock backend.
# Chance merges per sequence grow at most linearly with the number of
# sequences: at 3,840, 1 - 0.0061 * 3840 / 489 = 0.952; at 2,400, 0.970.
PURITY_FLOOR = 0.95
N_SPECIES, PER_SPECIES = 20, 120
NW_CHECKS = [(64, 1), (64, 64), (512, 1), (512, 64), (2048, 1), (2048, 64)]  # (bucket, batch)
NW_GAPS = [(2816, 256), (1100, 100)]  # the MSA engines' 11/1 in QUANT units; another pair
NW_TIMED = [(512, 64), (2048, 16)]  # full batches of the merge pipeline's caps


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SmokeError(what)


# ---------------------------------------------------------------------------
# phase 2/3 inputs
# ---------------------------------------------------------------------------

def sw_inputs(rng, B, L, bias, saa, s3d, dev):
    """Ragged code pairs; every other pair carries a planted homolog of a
    query window (substitutions plus one insertion and one deletion)."""
    import torch

    from unicore_tpu_torch.align.bias import bias_clip_bound

    qa = rng.randint(0, 20, (B, L)).astype(np.int32)
    qs = rng.randint(0, 20, (B, L)).astype(np.int32)
    ta = rng.randint(0, 20, (B, L)).astype(np.int32)
    ts = rng.randint(0, 20, (B, L)).astype(np.int32)
    ql = rng.randint(max(8, L // 4), L + 1, B).astype(np.int32)
    tl = rng.randint(max(8, L // 4), L + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        w = int(min(ql[b], tl[b]) * 0.8)
        off_q, off_t = rng.randint(0, ql[b] - w + 1), rng.randint(0, tl[b] - w + 1)
        seg_a, seg_s = qa[b, off_q:off_q + w].copy(), qs[b, off_q:off_q + w].copy()
        sub = rng.randint(0, w, w // 6)
        seg_a[sub] = rng.randint(0, 20, len(sub))
        c1, c2 = sorted(rng.randint(4, w - 4, 2))
        seg_a = np.concatenate([seg_a[:c1], rng.randint(0, 20, 5), seg_a[c1:c2], seg_a[c2 + 4:]])[:w]
        seg_s = np.concatenate([seg_s[:c1], rng.randint(0, 20, 5), seg_s[c1:c2], seg_s[c2 + 4:]])[:w]
        ta[b, off_t:off_t + len(seg_a)] = seg_a
        ts[b, off_t:off_t + len(seg_s)] = seg_s
    if bias == "off":
        qc = None
    elif bias == "on":
        qc = rng.randint(-60, 40, (B, L)).astype(np.int32)
    else:
        bound = int(bias_clip_bound(saa, s3d, 4.0, 6.0))
        qc = rng.choice([-bound, bound], size=(B, L)).astype(np.int32)
    t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa: E731
    return [t(x) for x in (qa, qs, ta, ts, ql, tl)], t(qc)


def cells_of(args):
    ql, tl = args[4].double(), args[5].double()
    return float((ql * tl).sum())


def bytes_of(args, qc):
    n = sum(x.numel() * x.element_size() for x in args)
    n += 0 if qc is None else qc.numel() * qc.element_size()
    return n + 2 * 21 * 21 * 4 + args[0].shape[0] * 12


def bound_of(ctx, args, qc, kind):
    """(bound_ms, ops_ms, bytes_ms) of one launch on these inputs."""
    ops_ms = cells_of(args) * (OPS_PER_CELL[kind] + 1) / ctx["peak_ops"] * 1e3
    bytes_ms = bytes_of(args, qc) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def time_cuda(fn, n):
    """ms per call of `fn`: CUDA events around n back-to-back calls, after
    two warm-up calls, so the host's work per call overlaps the device's."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def run_steps(steps, out_dir, home, device=None):
    """Run `python -m unicore_tpu_torch` steps [(name, argv)], each a
    subprocess with HOME=home; returns ({name: seconds}, {name: counters})."""
    env = dict(os.environ, HOME=home, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("UNICORE_TPU_TORCH_DEVICE", None)
    if device:
        env["UNICORE_TPU_TORCH_DEVICE"] = device
    os.makedirs(out_dir, exist_ok=True)
    times, counters = {}, {}
    for stage, argv in steps:
        cfile = os.path.join(out_dir, f"{stage}.counters.json")
        env["UNICORE_TPU_TORCH_COUNTERS"] = cfile
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "unicore_tpu_torch", *argv, "-v", "2"],
                             cwd=ROOT, env=env, capture_output=True, text=True)
        times[stage] = time.perf_counter() - t0
        if res.returncode != 0:
            raise SmokeError(f"{stage} exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        counters[stage] = json.load(open(cfile))
    return times, counters


def run_slice(in_dir, out_dir, home, device=None):
    """createdb -> cluster -> profile -> tree -n through the CLI."""
    db = os.path.join(out_dir, "proteome", "proteome_db")
    steps = [
        ("createdb", ["createdb", in_dir, db, "mock"]),
        ("cluster", ["cluster", db, os.path.join(out_dir, "cluster", "clust"),
                     os.path.join(out_dir, "tmp")]),
        ("profile", ["profile", db, os.path.join(out_dir, "cluster", "clust.tsv"),
                     os.path.join(out_dir, "profile")]),
        ("tree", ["tree", db, os.path.join(out_dir, "profile"), os.path.join(out_dir, "tree"), "-n"]),
    ]
    return run_steps(steps, out_dir, home, device)


def run_easy_core(in_dir, out_dir, home, device=None):
    """easy-core -n, then tree -n with the two other aligners on its
    database and core genes."""
    db = os.path.join(out_dir, "proteome", "proteome_db")
    prof = os.path.join(out_dir, "profile")
    steps = [
        ("easy-core", ["easy-core", in_dir, out_dir, "mock", os.path.join(out_dir, "tmp"), "-n"]),
        ("tree_mafft", ["tree", db, prof, os.path.join(out_dir, "tree_mafft"), "-n", "-A", "mafft"]),
        ("tree_linsi", ["tree", db, prof, os.path.join(out_dir, "tree_linsi"), "-n",
                        "-A", "mafft-linsi"]),
    ]
    return run_steps(steps, out_dir, home, device)


def check_tree(out_dir, n_species):
    """The tree stage's outputs: a filtered MSA for every core gene, whose
    rows ungapped are the gene's input sequences, and a supermatrix with
    one row per species whose partitions tile its width.  Returns
    (genes, supermatrix width, partitions)."""
    from unicore_tpu_torch.io.fasta import read_fasta

    tree = os.path.join(out_dir, "tree")
    genes = sorted(n[:-4] for n in os.listdir(os.path.join(out_dir, "profile")) if n.endswith(".txt"))
    check(len(genes) > 0, "no core genes")
    for g in genes:
        gdir = os.path.join(tree, "fasta", g)
        check(os.path.isfile(os.path.join(gdir, f"{g}.fa.filtered")), f"core gene {g} has no filtered MSA")
        msa = read_fasta(os.path.join(gdir, f"{g}_aa.fa"))
        check(len({len(r) for r in msa.values()}) == 1, f"rows of {g}_aa.fa differ in length")
        check({k: r.replace("-", "") for k, r in msa.items()} == read_fasta(os.path.join(gdir, "aa.fasta")),
              f"rows of {g}_aa.fa, ungapped, are not the gene's input sequences")
    combined = read_fasta(os.path.join(tree, "combined.fasta"))
    widths = {len(r) for r in combined.values()}
    check(len(widths) == 1, f"combined.fasta rows differ in length: {sorted(widths)}")
    check(len(combined) == n_species, f"combined.fasta has {len(combined)} rows for {n_species} species")
    width = widths.pop()
    parts = [line.rsplit("=", 1)[1].split("-") for line in
             open(os.path.join(tree, "combined.fasta.partitions")).read().splitlines()]
    pos = 1
    for a, b in parts:
        check(int(a) == pos and int(b) >= pos - 1, f"partition {a}-{b} does not start at column {pos}")
        pos = int(b) + 1
    check(pos == width + 1 and len(parts) == len(genes),
          f"{len(parts)} partitions end at column {pos - 1}; width {width}, {len(genes)} core genes")
    return genes, width, len(parts)


def read_files(root, skip=(".counters.json",)):
    out = {}
    for d, _, names in os.walk(root):
        if os.path.relpath(d, root).split(os.sep)[0] == "tmp":
            continue
        for n in names:
            if not n.endswith(skip):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    """Phase 1: the card, the versions, the kernel's build; returns the
    context the other phases share."""
    import torch

    from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
    from unicore_tpu_torch.ops import sw_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    peak_ops = props.multi_processor_count * LANES_PER_SM * float(clock) * 1e6
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {props.name}, "
        f"{props.multi_processor_count} SMs, max SM clock {clock} MHz, "
        f"peak scalar rate {peak_ops / 1e12:.2f} Tops/s")
    build_s = sw_cuda.build()
    log(f"[phase 1] kernel built from {os.path.relpath(sw_cuda.SOURCE, ROOT)} in {build_s:.1f} s")
    dev = torch.device("cuda")
    saa_np = get_aa_matrix().astype(np.float32)
    s3d_np = get_3di_matrix().astype(np.float32)
    return dict(dev=dev, peak_ops=peak_ops, saa_np=saa_np, s3d_np=s3d_np,
                saa=torch.from_numpy(saa_np).to(dev), s3d=torch.from_numpy(s3d_np).to(dev),
                rng=np.random.RandomState(20261016))


def phase_exact(ctx):
    """Phase 2: kernel vs plain version, bit-exact; returns the largest
    |best| difference per mode (0 when exact)."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain
    from unicore_tpu_torch.synthetic import SW_EDGE_CASES, sw_edge_pairs

    saa, s3d = ctx["saa"], ctx["s3d"]
    max_err = {"gapped": 0.0, "ungapped": 0.0}
    n_cmp = 0
    t0 = time.perf_counter()
    for B, L in SHAPES:
        for bias in ("off", "on", "clip"):
            args, qc = sw_inputs(ctx["rng"], B, L, bias, ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
            for mode, kw in MODES.items():
                for go, ge in (GAPS if mode != "ungapped" else GAPS[:1]):
                    k = sw_cuda.sw_forward_cuda(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw)
                    p = sw_forward_plain(*args, saa, s3d, go=go, ge=ge, qc=qc, **kw)
                    torch.cuda.synchronize()
                    kind = "ungapped" if mode == "ungapped" else "gapped"
                    err = float((k[0] - p[0]).abs().max())
                    max_err[kind] = max(max_err[kind], err)
                    ok = all(torch.equal(a, b) for a, b in zip(k, p))
                    check(ok, f"kernel != plain at B={B} L={L} {mode} bias={bias} go/ge={go}/{ge}: "
                              f"max |best| err {err}, qend diff {int((k[1] != p[1]).sum())}, "
                              f"tend diff {int((k[2] != p[2]).sum())}")
                    n_cmp += 1
    dev = ctx["dev"]
    for s, (B, Lq, Lt) in enumerate(EDGE_SHAPES):
        modes = [dict(gap_window=w) for w in EDGE_WINDOWS + [Lt, 2 * Lt]] + [dict(ungapped=True)]
        for n, kw in enumerate(modes):
            if (n + s) % 2:  # half the settings per shape, the other half on the next
                continue
            case = SW_EDGE_CASES[(n + Lt) % len(SW_EDGE_CASES)]
            arrays, go, ge = sw_edge_pairs(ctx["rng"], case, B, Lq, Lt)
            t = [torch.from_numpy(x).to(dev) for x in arrays]
            k = sw_cuda.sw_forward_cuda(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            p = sw_forward_plain(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            torch.cuda.synchronize()
            kind = "ungapped" if kw.get("ungapped") else "gapped"
            err = float((k[0] - p[0]).abs().max())
            max_err[kind] = max(max_err[kind], err)
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"kernel != plain at B={B} Lq={Lq} Lt={Lt} {kw} case={case}: max |best| err {err}, "
                  f"qend diff {int((k[1] != p[1]).sum())}, tend diff {int((k[2] != p[2]).sum())}")
            n_cmp += 1
    log(f"[phase 2] {n_cmp} kernel-vs-plain comparisons bit-exact on (best, qend, tend) "
        f"in {time.perf_counter() - t0:.1f} s")
    return max_err


def phase_times(ctx, shapes=SHAPES, reps=50, plain_reps=2):
    """Phase 3: times per shape and mode, with the engine's settings
    (gap_window 64, bias on); returns {(B, L, kind): numbers}."""
    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain

    saa, s3d = ctx["saa"], ctx["s3d"]
    log("[phase 3] B L mode | kernel ms GCUPS | plain ms | bound ms (ops, bytes) | share of bound")
    timing = {}
    for B, L in shapes:
        args, qc = sw_inputs(ctx["rng"], B, L, "on", ctx["saa_np"], ctx["s3d_np"], ctx["dev"])
        cells = cells_of(args)
        for kind, kw in TIMED_MODES.items():
            ms = time_cuda(lambda: sw_cuda.sw_forward_cuda(*args, saa, s3d, qc=qc, **kw), reps)
            plain_ms = time_cuda(lambda: sw_forward_plain(*args, saa, s3d, qc=qc, **kw), plain_reps)
            bound_ms, ops_ms, bytes_ms = bound_of(ctx, args, qc, kind)
            timing[(B, L, kind)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", gcups=cells / ms / 1e6)
            log(f"  {B:4d} {L:5d} {kind:8s} | {ms:9.4f} {cells / ms / 1e6:7.1f} | "
                f"{plain_ms:9.2f} | {bound_ms:.4f} ({ops_ms:.4f}, {bytes_ms:.5f}) | "
                f"{100 * bound_ms / ms:.1f} %")
    return timing


def device_busy_ms(fn):
    """(device kernel ms, wall ms) of one call of `fn` under torch.profiler;
    device ms is None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = 0.0
    for e in prof.key_averages():
        v = getattr(e, "self_device_time_total", None)
        us += getattr(e, "self_cuda_time_total", 0.0) if v is None else v
    return (us / 1e3 if us > 0 else None), wall_ms


def phase_nw(ctx):
    """Phase 3b: the NW forward on the card vs the CPU, bit-identical; its
    time per dispatch at the merge pipeline's full batches.  Returns
    {(bucket, batch): numbers}."""
    import torch

    from unicore_tpu_torch.ops.nw_device import nw_forward_bits
    from unicore_tpu_torch.synthetic import nw_scores

    t0 = time.perf_counter()
    n_cmp = 0
    for c, (Lb, B) in enumerate(NW_CHECKS):
        # tie-heavy scores with the second gap pair, but not at the
        # largest size, whose CPU side takes seconds
        cases = list(zip(NW_GAPS, ("rand", ("zero", "const")[c % 2])))
        for (go, ge), kind in cases[:1] if (Lb, B) == NW_CHECKS[-1] else cases:
            S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb - 5 * (c % 3), kind)
            t = [torch.from_numpy(x) for x in (S, l1, l2)]
            cpu = nw_forward_bits(*t, go, ge)
            gpu = nw_forward_bits(*(x.to(ctx["dev"]) for x in t), go, ge)
            for name, x, y in zip(("bits", "end_i", "end_j", "score"), cpu, gpu):
                check(y.is_cuda and torch.equal(x, y.cpu()),
                      f"NW forward on CUDA != CPU in {name} at bucket {Lb}, batch {B}, {kind}, go/ge {go}/{ge}")
            n_cmp += 1
    log(f"[phase 3b] {n_cmp} NW forward CUDA-vs-CPU comparisons bit-identical on "
        f"(bits, end_i, end_j, score) in {time.perf_counter() - t0:.1f} s")
    log("  bucket batch | ms per dispatch | CPU ms | device busy ms in one profiled dispatch (its wall ms)")
    timing = {}
    for Lb, B in NW_TIMED:
        S, l1, l2 = nw_scores(ctx["rng"], B, Lb, Lb, "rand")
        t = [torch.from_numpy(x) for x in (S, l1, l2)]
        d = [x.to(ctx["dev"]) for x in t]
        ms = time_cuda(lambda: nw_forward_bits(*d, *NW_GAPS[0]), 3)
        c0 = time.perf_counter()
        nw_forward_bits(*t, *NW_GAPS[0])
        cpu_ms = (time.perf_counter() - c0) * 1e3
        busy_ms, wall_ms = device_busy_ms(lambda: nw_forward_bits(*d, *NW_GAPS[0]))
        timing[(Lb, B)] = dict(ms=ms, cpu_ms=cpu_ms, busy_ms=busy_ms, profiled_wall_ms=wall_ms)
        busy = "not measured" if busy_ms is None else f"{busy_ms:.2f}"
        log(f"  {Lb:6d} {B:5d} | {ms:10.2f} | {cpu_ms:9.2f} | {busy} ({wall_ms:.2f})")

    # the other device work of the tree stage: the fused merge's count
    # products and quantization at a full (64, 512) batch, and the guide
    # tree's gram over 2,048 k-mer bags; each equal to its CPU result
    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.nw_device import _count_scores

    B, Lb = NW_TIMED[0][1], NW_TIMED[0][0]
    mats = []
    for m in (ctx["saa_np"], ctx["s3d_np"]):
        p = np.zeros((32, 32))
        p[:21, :21] = m[:21, :21]
        mats.append(torch.from_numpy(p))
    counts = [torch.from_numpy(ctx["rng"].randint(0, 6, (B, Lb, 32)).astype(np.int16)) for _ in range(4)]
    n = torch.full((B,), 5, dtype=torch.int32)
    lens = torch.from_numpy(ctx["rng"].randint(1, Lb + 1, B).astype(np.int32))
    args = [*counts, n, n, lens, lens.flip(0), *mats, 14, 21]
    dargs = [x.to(ctx["dev"]) if torch.is_tensor(x) else x for x in args]
    check(torch.equal(_count_scores(*args), _count_scores(*dargs).cpu()), "count scores on CUDA != CPU")
    timing["counts"] = time_cuda(lambda: _count_scores(*dargs), 5)
    feats = (ctx["rng"].rand(2048, 8192) < 0.05).astype(np.int8)
    check(np.array_equal(_shared_counts(feats, "cpu"), _shared_counts(feats, ctx["dev"])),
          "guide gram on CUDA != CPU")
    timing["gram"] = time_cuda(lambda: _shared_counts(feats, ctx["dev"]), 3)
    log(f"  count products + quantization at {B} x {Lb} x {Lb}: {timing['counts']:.3f} ms; "
        f"guide gram of 2048 x 8192 bags (copies included): {timing['gram']:.3f} ms")
    return timing


def phase_slice(work, n_species=N_SPECIES, per_species=PER_SPECIES):
    """Phase 4: createdb -> cluster -> profile -> tree -n at a real size;
    returns the kernel's launches per mode in that run."""
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.ops import sw_cuda

    # the main path runs in the CLI subprocesses below, whose counts start
    # at 0 and are read back from their counters files
    sw_cuda.reset_launch_counts()
    in_dir = os.path.join(work, "proteomes")
    labels = synthetic.write_proteomes(in_dir, n_species, per_species, seed=7)
    lengths = []
    for fn in os.listdir(in_dir):
        lengths += [len(l.strip()) for l in open(os.path.join(in_dir, fn)) if not l.startswith(">")]
    lengths = np.array(lengths)
    log(f"[phase 4] {len(lengths)} sequences ({n_species} x {per_species}), median length "
        f"{int(np.median(lengths))}, {100 * np.mean(lengths > 1024):.1f}% longer than 1024")
    out_dir = os.path.join(work, "main")
    times, counters = run_slice(in_dir, out_dir, os.path.join(work, "home_main"))
    c, t = counters["cluster"], counters["tree"]
    launches = {k: int(c.get(f"kernel.sw.{k}.launches", 0)) for k in ("gapped", "ungapped")}
    purity, n_clusters = synthetic.cluster_purity(out_dir, labels)
    genes, width, n_parts = check_tree(out_dir, n_species)
    for stage in ("createdb", "cluster", "profile", "tree"):
        log(f"  {stage:8s} {times[stage]:8.2f} s")
    log(f"  sequences {int(c['cluster.sequences'])}, candidate pairs {int(c['cluster.candidate_pairs'])}, "
        f"kept by rescore {int(c['rescore.kept'])}, hits {int(c['cluster.hits'])}, "
        f"clusters {int(c['cluster.clusters'])}, core genes {len(genes)}")
    log(f"  align.cells {c['align.cells']:.4g}, rescore.cells {c['rescore.cells']:.4g}, "
        f"align.seconds {c['align.seconds']:.2f}, rescore.seconds {c['rescore.seconds']:.2f}, "
        f"banded.seconds {c.get('banded.seconds', 0.0):.2f} (inside the two before), "
        f"stage.cluster.seconds {c['stage.cluster.seconds']:.2f}")
    log(f"  tree: genes aligned {len(genes)}, msa.cells {t['msa.cells']:.4g}, "
        f"msa.seconds {t['msa.seconds']:.2f}, msa.nw.seconds {t['msa.nw.seconds']:.2f}, "
        f"msa.dispatches {int(t['msa.dispatches'])}, host-route merges "
        f"{int(t.get('msa.host_route_merges', 0))}, stage.tree.seconds {t['stage.tree.seconds']:.2f}; "
        f"supermatrix {n_species} x {width}, {n_parts} partitions")
    log(f"  kernel launches {launches}; cluster purity {purity:.4f} over {n_clusters} clusters "
        f"(floor {PURITY_FLOOR})")
    check(launches["gapped"] > 0 and launches["ungapped"] > 0,
          f"the main path did not launch both kernel modes: {launches}")
    check(purity >= PURITY_FLOOR, f"cluster purity {purity:.4f} < {PURITY_FLOOR}")
    check(t["msa.dispatches"] > 0, "the tree stage ran no NW forward")
    return launches


def phase_crosscheck(work):
    """Phase 5: easy-core -n and the two other aligners on CUDA and on the
    CPU, byte-identical."""
    from unicore_tpu_torch import synthetic

    small = os.path.join(work, "small")
    synthetic.write_proteomes(small, 3, 40, seed=11, long_family=True)
    t0 = time.perf_counter()
    run_easy_core(small, os.path.join(work, "x_cuda"), os.path.join(work, "home_cuda"))
    _, cpu_counters = run_easy_core(small, os.path.join(work, "x_cpu"), os.path.join(work, "home_cpu"),
                                    device="cpu")
    a, b = read_files(os.path.join(work, "x_cuda")), read_files(os.path.join(work, "x_cpu"))
    check(sorted(a) == sorted(b), f"file sets differ: {sorted(set(a) ^ set(b))}")
    diff = [n for n in sorted(a) if a[n] != b[n]]
    check(not diff, f"CUDA and CPU outputs differ: {diff}")
    for want in ("cluster/clust.tsv", "tree/combined.fasta", "tree_mafft/combined.fasta",
                 "tree_linsi/combined.fasta.partitions"):
        check(want in a, f"cross-check wrote no {want}")
    check(any(n.startswith("profile/") and n.endswith(".txt") for n in a), "cross-check found no core genes")
    check(sum(int(cpu_counters["easy-core"].get(f"kernel.sw.{k}.launches", 0))
              for k in ("gapped", "ungapped")) == 0, "the CPU run launched the kernel")
    log(f"[phase 5] CUDA and CPU runs of easy-core -n and tree -n (mafft, mafft-linsi) wrote "
        f"{len(a)} byte-identical files in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    ctx = phase_env()
    max_err = phase_exact(ctx)
    timing = phase_times(ctx)
    phase_nw(ctx)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_slice(work)
        phase_crosscheck(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for kind in ("gapped", "ungapped"):
        t = timing[(*KERNEL_SHAPE, kind)]
        kernels.append({
            "name": f"sw_forward_{kind}", "route": "cuda",
            "source": "unicore_tpu_torch/csrc/sw.cu",
            "replaces": "unicore_tpu/ops/sw.py:183",
            "launches": launches[kind], "max_abs_err": max_err[kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
