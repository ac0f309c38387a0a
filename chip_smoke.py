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
3c. The likelihood (phylo/likelihood.py, PyTorch ops) on the card against
   the same calls on the CPU, with `torch.set_float32_matmul_precision
   ("high")` set, so the engine's full-float32 guard is what keeps TF32
   out: at 20 taxa x 8,192 columns (JTT+F+I+G) `loglik_batch` on a
   64-candidate NNI batch, `site_loglik_batch` on 16 of them,
   `loglik_nni_moves`, a 30-step `optimize_blens` and the pattern-chunked
   path (chunks forced to 2,048 patterns; fewer candidates and steps),
   and the incremental path at 64 taxa; the CPU side is what costs.  Tolerances as in
   tests/test_torch_phylo.py: lnL within LL_RTOL relative, sites within
   SITE_ATOL + SITE_RTOL |s|, after Adam lnL within BLEN_LL_RTOL and
   each length within BLEN_ATOL + BLEN_RTOL len.  Then ms per
   `loglik_batch` call and per Adam step, the device-busy share of Adam
   steps from a torch.profiler trace, and the bound of one `loglik_batch`:
   max(flops of its products at C x 20 x 20 per category and node /
   67 TFLOP/s FP32, bytes read and written once / 3.35 TB/s).
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
   per species whose partitions tile its width.  Then `tree` again on the
   same output directory with its defaults (iqtree, -m JTT+F+I+G -B 1000):
   it takes the skip path and runs inference alone, timed apart.  Requires
   iqtree.treefile with the species as leaves, a support in [0, 100] on
   every internal split but at most one (the JAX package, and the port
   with it, leaves the root split of the rooted search tree unlabelled
   when both root children are internal), a finite lnL in iqtree.iqtree,
   tree.chk "1", and
   a normalized RF distance to the tree the proteomes evolved along
   (synthetic.species_tree) of at most RF_FLOOR.
5. Cross-check on 5 species x 40 proteins (one family longer than 1,024:
   the banded path and the 2,048 NW bucket): `easy-core` with its
   defaults, then `tree -n -A mafft` and `tree -n -A mafft-linsi` on its
   outputs, and `tree -T fasttree` and `tree -T raxml-ng` on copies of its
   supermatrix (the skip path), on CUDA and on the CPU
   (UNICORE_TPU_TORCH_DEVICE=cpu), each with its own HOME.  The same
   files, every one before inference byte-identical; the inference
   outputs parsed: the same topology (RF 0), branch lengths within
   BLEN_ATOL + BLEN_RTOL len, supports within SUPPORT_POINTS, lnL within
   BLEN_LL_RTOL, every other report line equal but `seconds`.

Order of the run: phase 5's CPU run starts first, on every core but two,
and goes on beside phase 1, the checks of phases 2, 3b and 3c and phase
5's CUDA run, which run on those two.  Once it has ended, phase 3, the
times of phases 3b and 3c and phase 4 run with nothing beside them.

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel mode: launches in phase 4, times and bound at (512, 512), the
main path's most common bucket); the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits non-zero before
printing any result.  Nothing here imports JAX or unicore_tpu.
"""

from __future__ import annotations

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
FP32_FLOPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
PHYLO = dict(n=20, L=8192, batch=64, model="JTT+F+I+G", alpha=0.7, p_inv=0.05, seed=5,
             steps=30)  # Adam steps of the CUDA-vs-CPU check
PHYLO_INC = dict(n=64, L=2000, seed=6)  # the incremental NNI path starts at 48 taxa
# likelihood tolerances, CUDA against the CPU (those of tests/test_torch_phylo.py)
LL_RTOL, SITE_ATOL, SITE_RTOL = 1e-5, 1e-4, 1e-3
BLEN_LL_RTOL, BLEN_ATOL, BLEN_RTOL = 1e-4, 1e-3, 1e-2
SUPPORT_POINTS = 1.0
RF_FLOOR = 0.2  # normalized RF of phase 4's tree to the generating species tree
CROSS_SPECIES, CROSS_PER_SPECIES = 5, 40


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


_RUNNING = set()  # CLI subprocesses in flight, killed by stop_cli_runs()
_RUNNING_LOCK = threading.Lock()
_STOPPED = threading.Event()


def stop_cli_runs():
    """Kill every CLI subprocess in flight and start no more."""
    with _RUNNING_LOCK:
        _STOPPED.set()
        for proc in _RUNNING:
            proc.kill()


def run_steps(steps, out_dir, home, device=None, threads=None):
    """Run `python -m unicore_tpu_torch` steps [(name, argv)], each a
    subprocess with HOME=home (and `threads` torch threads, if given);
    returns ({name: seconds}, {name: counters})."""
    env = dict(os.environ, HOME=home, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("UNICORE_TPU_TORCH_DEVICE", None)
    if device:
        env["UNICORE_TPU_TORCH_DEVICE"] = device
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    os.makedirs(out_dir, exist_ok=True)
    times, counters = {}, {}
    for stage, argv in steps:
        cfile = os.path.join(out_dir, f"{stage}.counters.json")
        env["UNICORE_TPU_TORCH_COUNTERS"] = cfile
        t0 = time.perf_counter()
        with _RUNNING_LOCK:
            if _STOPPED.is_set():
                raise SmokeError(f"{stage} not started: the run is stopping")
            proc = subprocess.Popen([sys.executable, "-m", "unicore_tpu_torch", *argv, "-v", "2"], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            _RUNNING.add(proc)
        try:
            out, err = proc.communicate()
        finally:
            _RUNNING.discard(proc)
        times[stage] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeError(f"{stage} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
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


def run_easy_core(in_dir, out_dir, home, device=None, threads=None):
    """easy-core with its defaults, then, on its database, core genes and
    copies of its supermatrix: tree -T raxml-ng beside tree -n with the two
    other aligners followed by tree -T fasttree (raxml-ng's three starts
    take as long as the three others; each side gets half the threads)."""
    db = os.path.join(out_dir, "proteome", "proteome_db")
    prof = os.path.join(out_dir, "profile")
    times, counters = run_steps(
        [("easy-core", ["easy-core", in_dir, out_dir, "mock", os.path.join(out_dir, "tmp")])],
        out_dir, home, device, threads)
    for sub in ("tree_fasttree", "tree_raxml"):
        os.makedirs(os.path.join(out_dir, sub))
        for f in ("combined.fasta", "combined.fasta.partitions"):
            shutil.copy(os.path.join(out_dir, "tree", f), os.path.join(out_dir, sub, f))
    sides = [
        [("tree_raxml", ["tree", db, prof, os.path.join(out_dir, "tree_raxml"), "-T", "raxml-ng"])],
        [("tree_mafft", ["tree", db, prof, os.path.join(out_dir, "tree_mafft"), "-n", "-A", "mafft"]),
         ("tree_linsi", ["tree", db, prof, os.path.join(out_dir, "tree_linsi"), "-n", "-A", "mafft-linsi"]),
         ("tree_fasttree", ["tree", db, prof, os.path.join(out_dir, "tree_fasttree"), "-T", "fasttree"])],
    ]
    half = threads and max(1, threads // 2)
    with ThreadPoolExecutor(len(sides)) as pool:
        for side_times, side_counters in pool.map(
                lambda steps: run_steps(steps, out_dir, home, device, half), sides):
            times.update(side_times)
            counters.update(side_counters)
    return times, counters


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


TREE_FILES = ("iqtree.treefile", "fasttree.nwk", "raxml-ng.raxml.bestTree", "raxml-ng.raxml.support")
REPORT_FILES = ("iqtree.iqtree", "iqtree.log")


def tree_edges(text):
    """{split: (length, support)} of a Newick tree, leaf edges included; a
    split is its smaller side (ties: the sorted-first)."""
    from unicore_tpu_torch.phylo.newick import parse_newick

    tree = parse_newick(text)
    everyone = frozenset(x.name for x in tree.leaves())
    out = {}
    for node in tree.postorder():
        if node is not tree:
            below = frozenset(x.name for x in node.leaves())
            out[min(below, everyone - below, key=lambda s: (len(s), sorted(s)))] = (node.length, node.support)
    return out


def unlabelled_splits(edges):
    """Internal splits without a support.  At most one is allowed: the JAX
    package, and the port with it, leaves the root split of the rooted
    search tree unlabelled when both root children are internal."""
    return [k for k, (_, sup) in edges.items() if len(k) > 1 and sup is None]


def check_same_tree(ref, got, what, supported):
    """The CUDA tree `got` against the CPU tree `ref`: the same splits (RF
    0), lengths within BLEN_ATOL + BLEN_RTOL len; with `supported`, at most
    one unlabelled internal split in each, and every support both write
    in [0, 100] and within SUPPORT_POINTS."""
    from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance

    rf = rf_distance(parse_newick(ref), parse_newick(got))
    a, b = tree_edges(ref), tree_edges(got)
    check(rf == 0 and set(a) == set(b), f"{what}: RF {rf} between the CUDA and CPU trees")
    if supported:
        check(max(len(unlabelled_splits(a)), len(unlabelled_splits(b))) <= 1,
              f"{what}: internal splits without a support: {unlabelled_splits(a)}, {unlabelled_splits(b)}")
    for k in a:
        (la, sa), (lb, sb) = a[k], b[k]
        check(abs(lb - la) <= BLEN_ATOL + BLEN_RTOL * la, f"{what}: branch {sorted(k)} {la} vs {lb}")
        if supported and len(k) > 1 and sa is not None and sb is not None:
            check(0.0 <= sb <= 100.0 and abs(sb - sa) <= SUPPORT_POINTS,
                  f"{what}: split {sorted(k)} support {sa} vs {sb}")


def report_lines(data):
    return dict(line.split(": ", 1) for line in data.decode().splitlines() if ": " in line)


def check_same_files(a, b):
    """CUDA files `b` against CPU files `a`: the same names, inference
    outputs compared after parsing, every other file byte-identical.
    Returns the number of inference outputs compared."""
    check(sorted(a) == sorted(b), f"file sets differ: {sorted(set(a) ^ set(b))}")
    n_inf = 0
    for name in sorted(a):
        base = os.path.basename(name)
        if base in TREE_FILES:
            check_same_tree(a[name].decode(), b[name].decode(), name, not base.endswith("bestTree"))
        elif base in REPORT_FILES:
            ra, rb = report_lines(a[name]), report_lines(b[name])
            la, lb = float(ra.pop("lnL")), float(rb.pop("lnL"))
            check(abs(lb - la) <= BLEN_LL_RTOL * abs(la), f"{name}: lnL {la} vs {lb}")
            ra.pop("seconds"), rb.pop("seconds")
            check(ra == rb, f"{name}: report lines differ: {ra} vs {rb}")
        else:
            check(a[name] == b[name], f"CUDA and CPU outputs differ: {name}")
            continue
        n_inf += 1
    return n_inf


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
    """Phase 3b, checks: the NW forward on the card vs the CPU,
    bit-identical; the fused merge's count products at a full (64, 512)
    batch and the guide tree's gram over 2,048 k-mer bags, each equal to
    its CPU result.  Returns the card's inputs of phase_nw_times."""
    import torch

    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.nw_device import _count_scores, nw_forward_bits
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
    feats = (ctx["rng"].rand(2048, 8192) < 0.05).astype(np.int8)
    check(np.array_equal(_shared_counts(feats, "cpu"), _shared_counts(feats, ctx["dev"])),
          "guide gram on CUDA != CPU")
    log(f"[phase 3b] {n_cmp} NW forward CUDA-vs-CPU comparisons bit-identical on "
        f"(bits, end_i, end_j, score), count products and guide gram equal, in {time.perf_counter() - t0:.1f} s")
    return dict(count_args=dargs, feats=feats)


def phase_nw_times(ctx, inputs):
    """Phase 3b, times: the NW forward per dispatch at the merge pipeline's
    full batches, its CPU time and the device's busy time inside one
    dispatch; the count products and the guide gram.  Returns
    {(bucket, batch): numbers, "counts": ms, "gram": ms}."""
    import torch

    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.nw_device import _count_scores, nw_forward_bits
    from unicore_tpu_torch.synthetic import nw_scores

    log("[phase 3b] bucket batch | ms per dispatch | CPU ms | device busy ms in one profiled dispatch (its wall ms)")
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
    B, Lb = NW_TIMED[0][1], NW_TIMED[0][0]
    timing["counts"] = time_cuda(lambda: _count_scores(*inputs["count_args"]), 5)
    timing["gram"] = time_cuda(lambda: _shared_counts(inputs["feats"], ctx["dev"]), 3)
    log(f"  count products + quantization at {B} x {Lb} x {Lb}: {timing['counts']:.3f} ms; "
        f"guide gram of 2048 x 8192 bags (copies included): {timing['gram']:.3f} ms")
    return timing


def _rel_err(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def _site_err(ref, got):
    """Largest |d| / (SITE_ATOL + SITE_RTOL |s|): at most 1 to pass."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    check(ref.shape == got.shape, f"site log-likelihood shapes {ref.shape} != {got.shape}")
    return float(np.max(np.abs(got - ref) / (SITE_ATOL + SITE_RTOL * np.abs(ref))))


def _phylo_pair(msa, model, alpha, p_inv, dev):
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import models as tm

    names = list(msa)
    seqs = [msa[k] for k in names]
    freqs = tl.empirical_frequencies(tl.msa_to_codes(names, seqs))
    m = tm.SubstModel.build(tm.ModelSpec.parse(model), empirical_freqs=freqs, alpha=alpha, p_inv=p_inv)
    return tl.LikelihoodEngine(names, seqs, m, device="cpu"), tl.LikelihoodEngine(names, seqs, m, device=dev)


def _nj_start(msa, floor):
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo.nj import neighbor_joining, protein_distances

    names = list(msa)
    root = tl.make_root_binary(neighbor_joining(protein_distances(names, [msa[k] for k in names]), names))
    c, b = tl.tree_to_arrays(root, names)
    return c, np.maximum(b, floor)


@contextlib.contextmanager
def tf32_requested():
    """`torch.set_float32_matmul_precision("high")` inside the block, so the
    likelihood engine's full-float32 guard is what keeps TF32 out."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def phase_phylo(ctx):
    """Phase 3c, checks: the likelihood engine on the card against the CPU
    under TF32 matmul settings.  Returns the inputs of phase_phylo_times."""
    import torch

    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.synthetic import simulate_msa

    real_chunk_for = tl.pattern_chunk_for
    with tf32_requested(), contextlib.ExitStack() as undo:
        undo.callback(setattr, tl, "pattern_chunk_for", real_chunk_for)
        t0 = time.perf_counter()
        rng = np.random.RandomState(PHYLO["seed"])
        msa = simulate_msa(rng, PHYLO["n"], PHYLO["L"])
        cpu, gpu = _phylo_pair(msa, PHYLO["model"], PHYLO["alpha"], PHYLO["p_inv"], ctx["dev"])
        n, P, C = gpu.n, int(gpu.tips.shape[1]), int(gpu._mp["rates"].shape[0])
        check(gpu.tips.device.type == torch.device(ctx["dev"]).type,
              f"the likelihood engine's tensors are on {gpu.tips.device}")
        c, b = _nj_start(msa, 1e-3)
        names = gpu.names
        root = tl.arrays_to_tree(c, b, names)
        trees = ts.nni_neighbors(root)
        while len(trees) < PHYLO["batch"]:  # fill the batch with random NNI walks
            trees.append(ts.random_nni_walk(root, rng, 3))
        arr = [tl.tree_to_arrays(x, names) for x in trees[:PHYLO["batch"]]]
        cb, bb = np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])
        # the CPU side takes seconds per call at this size (about 8 s for
        # the 64 candidates, 0.25 s per Adam step), so the costlier checks
        # run on fewer candidates and steps than the timed calls
        err = {}
        err["loglik_batch"] = _rel_err(cpu.loglik_batch(cb, bb), gpu.loglik_batch(cb, bb))
        err["site_loglik_batch"] = _site_err(cpu.site_loglik_batch(cb[:16], bb[:16]),
                                             gpu.site_loglik_batch(cb[:16], bb[:16]))
        moves = ts.nni_moves_arrays(c, n)
        err["loglik_nni_moves"] = _rel_err(cpu.loglik_nni_moves(c, b, moves), gpu.loglik_nni_moves(c, b, moves))
        nb_c, ll_c = cpu.optimize_blens(c, b, steps=PHYLO["steps"])
        nb_g, ll_g = gpu.optimize_blens(c, b, steps=PHYLO["steps"])
        err["optimize_blens"] = _rel_err(ll_c, ll_g)
        blen_err = float(np.max(np.abs(nb_g - nb_c) / (BLEN_ATOL + BLEN_RTOL * nb_c)))
        tl.pattern_chunk_for = lambda n_taxa, n_cat, P, budget_bytes=8e8: 2048
        err["chunked loglik_batch"] = _rel_err(cpu.loglik_batch(cb[:8], bb[:8]),
                                               gpu.loglik_batch(cb[:8], bb[:8]))
        err["chunked site_loglik_batch"] = _site_err(cpu.site_loglik_batch(cb[:4], bb[:4]),
                                                     gpu.site_loglik_batch(cb[:4], bb[:4]))
        err["chunked optimize_blens"] = _rel_err(cpu.optimize_blens(c, b, steps=5)[1],
                                                 gpu.optimize_blens(c, b, steps=5)[1])
        tl.pattern_chunk_for = real_chunk_for
        msa64 = simulate_msa(np.random.RandomState(PHYLO_INC["seed"]), PHYLO_INC["n"], PHYLO_INC["L"])
        cpu64, gpu64 = _phylo_pair(msa64, PHYLO["model"], PHYLO["alpha"], PHYLO["p_inv"], ctx["dev"])
        c64, b64 = _nj_start(msa64, 0.02)
        moves64 = ts.nni_moves_arrays(c64, PHYLO_INC["n"])
        err[f"loglik_nni_moves at {PHYLO_INC['n']} taxa"] = _rel_err(cpu64.loglik_nni_moves(c64, b64, moves64),
                                                       gpu64.loglik_nni_moves(c64, b64, moves64))
        check(torch.get_float32_matmul_precision() == "high", "the engine did not restore the matmul precision")
        for name, e in err.items():
            lim = 1.0 if "site" in name else (BLEN_LL_RTOL if "optimize" in name else LL_RTOL)
            check(e <= lim, f"likelihood on CUDA != CPU: {name} error {e:.3g} > {lim}")
        check(blen_err <= 1.0, f"optimized branch lengths on CUDA != CPU: {blen_err:.3g} of the tolerance")
        log(f"[phase 3c] likelihood CUDA vs CPU under TF32 settings at {n} taxa x {P} patterns, "
            f"{C} categories, {len(cb)} candidates ({len(moves)} NNI moves; {len(moves64)} at "
            f"{PHYLO_INC['n']} taxa) in {time.perf_counter() - t0:.1f} s; errors (lnL relative; "
            f"sites and lengths as a share of their tolerance): "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items()) + f", branch lengths {blen_err:.3g}")
        return dict(cpu=cpu, gpu=gpu, c=c, b=b, cb=cb, bb=bb, moves=moves)


def phase_phylo_times(ctx, st):
    """Phase 3c, times (under TF32 settings, as the checks): ms per
    `loglik_batch` on the card and on the CPU, per Adam step, the
    device-busy share of Adam steps and the bound of one `loglik_batch`.
    Returns the numbers."""
    cpu, gpu, c, b, cb, bb, moves = (st[k] for k in ("cpu", "gpu", "c", "b", "cb", "bb", "moves"))
    n, P, C = gpu.n, int(gpu.tips.shape[1]), int(gpu._mp["rates"].shape[0])
    with tf32_requested():
        lb_ms = time_cuda(lambda: gpu.loglik_batch(cb, bb), 5)
        c0 = time.perf_counter()
        cpu.loglik_batch(cb, bb)
        lb_cpu_ms = (time.perf_counter() - c0) * 1e3
        sb_ms = time_cuda(lambda: gpu.site_loglik_batch(cb, bb), 3)
        nm_ms = time_cuda(lambda: gpu.loglik_nni_moves(c, b, moves), 3)
        walls = {}
        gpu.optimize_blens(c, b, steps=10)  # warm-up
        for steps in (10, 150):
            w0 = time.perf_counter()
            gpu.optimize_blens(c, b, steps=steps)
            walls[steps] = (time.perf_counter() - w0) * 1e3
        step_ms = (walls[150] - walls[10]) / 140
        busy_ms, prof_ms = device_busy_ms(lambda: gpu.optimize_blens(c, b, steps=10))
        # the bound of one loglik_batch call: per candidate and internal node
        # two products (P, C*20) x per-category (20, 20) blocks, at least
        # C * 20 * 20 multiply-adds per pattern each; bytes: tips, weights,
        # topologies and lengths read once, one lnL per candidate written
        B = len(cb)
        flops = B * (n - 1) * 2 * 2.0 * P * C * 20 * 20
        nbytes = n * P * 20 * 4 + P * 4 + cb.size * 8 + bb.size * 4 + B * 4
        bound_ms = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        busy = "not measured" if busy_ms is None else f"{busy_ms / 10:.3f} ms of it busy ({100 * busy_ms / prof_ms:.1f} %)"
        log(f"[phase 3c] loglik_batch ({B} candidates): {lb_ms:.2f} ms on the card, {lb_cpu_ms:.1f} ms on the CPU; "
            f"bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at FP32 peak, executed block-diagonally: "
            f"x{C}; {nbytes / 1e6:.2f} MB); site_loglik_batch {sb_ms:.2f} ms; loglik_nni_moves "
            f"({len(moves)} moves) {nm_ms:.2f} ms")
        log(f"  optimize_blens: {walls[150]:.1f} ms for 150 Adam steps, {step_ms:.3f} ms per step; "
            f"profiled 10-step call {prof_ms:.1f} ms, per step {busy}")
    return dict(loglik_batch_ms=lb_ms, loglik_batch_cpu_ms=lb_cpu_ms, bound_ms=bound_ms,
                adam_step_ms=step_ms, busy_ms=busy_ms, profiled_ms=prof_ms)


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
    phase_inference(work, out_dir, n_species)
    return launches


def phase_inference(work, out_dir, n_species):
    """Phase 4, second part: `tree` with its defaults on phase 4's output
    directory (the skip path: inference alone), and the checks of its
    iqtree outputs."""
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.phylo.newick import bipartitions, parse_newick, rf_distance

    db = os.path.join(out_dir, "proteome", "proteome_db")
    tree_dir = os.path.join(out_dir, "tree")
    times, counters = run_steps([("tree_inference", ["tree", db, os.path.join(out_dir, "profile"), tree_dir])],
                                out_dir, os.path.join(work, "home_main"))
    c = counters["tree_inference"]
    tree = parse_newick(open(os.path.join(tree_dir, "iqtree.treefile")).read())
    species = sorted(x.name for x in tree.leaves())
    check(species == [f"sp{i:02d}" for i in range(n_species)], f"iqtree.treefile leaves: {species}")
    every = [nd.support for nd in bipartitions(tree).values()]
    sup = [s for s in every if s is not None]
    check(len(every) == n_species - 3 and len(sup) >= len(every) - 1 and all(0.0 <= s <= 100.0 for s in sup),
          f"internal splits without a support in [0, 100] (one may have none): {every}")
    report = report_lines(open(os.path.join(tree_dir, "iqtree.iqtree"), "rb").read())
    lnl = float(report["lnL"])
    check(np.isfinite(lnl), f"lnL {lnl}")
    check(open(os.path.join(tree_dir, "tree.chk")).read() == "1", "tree.chk does not read 1")
    rf = rf_distance(tree, synthetic.species_tree(n_species, seed=7)) / (2 * (n_species - 3))
    log(f"  tree inference (skip path, iqtree -m JTT+F+I+G -B 1000) {times['tree_inference']:8.2f} s: "
        f"stage.tree.inference.seconds {c['stage.tree.inference.seconds']:.2f}, phylo.seconds "
        f"{c['phylo.seconds']:.2f}, phylo.patterns {int(c['phylo.patterns'])}, phylo.blen_steps "
        f"{int(c['phylo.blen_steps'])}, phylo.candidates {int(c['phylo.candidates'])}; lnL {lnl:.4f}, "
        f"alpha {report['alpha']}, p_inv {report['p_inv']}; {len(sup)} of {len(every)} splits labelled, "
        f"supports min {min(sup):.1f} mean {np.mean(sup):.1f}; normalized RF to the generating species tree {rf:.4f} (floor {RF_FLOOR})")
    check(rf <= RF_FLOOR, f"normalized RF {rf:.4f} to the generating species tree > {RF_FLOOR}")


def split_cores():
    """(foreground, background) CPU sets: two cores for the checks that
    drive the card, the others for phase 5's CPU run beside them.  With
    fewer than 4 cores both get every core: the run is slower, and still
    no timed phase has anything beside it."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return set(cores), set(cores)
    return set(cores[:2]), set(cores[2:])


def _on_cores(cores, fn, *args):
    """fn(*args) with the calling thread, and every process it starts,
    pinned to `cores` (Linux affinity is per thread and inherited)."""
    os.sched_setaffinity(0, cores)
    return fn(*args)


def start_crosscheck(work, pool, cores):
    """Phase 5, first half: write its proteomes and start its CPU run in
    `pool` on `cores`, with one torch thread per core; returns (input
    directory, the run's future)."""
    from unicore_tpu_torch import synthetic

    small = os.path.join(work, "small")
    synthetic.write_proteomes(small, CROSS_SPECIES, CROSS_PER_SPECIES, seed=11, long_family=True)
    return small, pool.submit(_on_cores, cores, run_easy_core, small, os.path.join(work, "x_cpu"),
                              os.path.join(work, "home_cpu"), "cpu", len(cores))


def phase_crosscheck(work, small, cpu_run, t0):
    """Phase 5: easy-core, the two other aligners and the two other tree
    builders on CUDA (here) and on the CPU (`cpu_run`, started at t0): the
    same files, byte-identical up to inference, the inference outputs
    within the stated tolerances."""
    cuda_times, _ = run_easy_core(small, os.path.join(work, "x_cuda"), os.path.join(work, "home_cuda"))
    cpu_times, cpu_counters = cpu_run.result()
    a, b = read_files(os.path.join(work, "x_cpu")), read_files(os.path.join(work, "x_cuda"))
    n_inf = check_same_files(a, b)
    for want in ("cluster/clust.tsv", "tree/combined.fasta", "tree/iqtree.treefile", "tree_mafft/combined.fasta",
                 "tree_linsi/combined.fasta.partitions", "tree_fasttree/fasttree.nwk",
                 "tree_raxml/raxml-ng.raxml.support"):
        check(want in a, f"cross-check wrote no {want}")
    check(a["tree/tree.chk"] == b"1", "easy-core's tree.chk does not read 1")
    check(any(n.startswith("profile/") and n.endswith(".txt") for n in a), "cross-check found no core genes")
    check(sum(int(cpu_counters["easy-core"].get(f"kernel.sw.{k}.launches", 0))
              for k in ("gapped", "ungapped")) == 0, "the CPU run launched the kernel")
    log(f"[phase 5] CUDA and CPU runs of easy-core, tree -n (mafft, mafft-linsi) and tree -T fasttree|raxml-ng "
        f"at {CROSS_SPECIES} x {CROSS_PER_SPECIES}: {len(a)} files, {len(a) - n_inf} byte-identical, "
        f"{n_inf} inference outputs within tolerance; {time.perf_counter() - t0:.1f} s since the CPU run "
        f"started beside phases 1-3c")
    log("  step      CUDA s    CPU s")
    for k in cuda_times:
        log(f"  {k:12s} {cuda_times[k]:7.2f} {cpu_times[k]:8.2f}")


def checks_beside_cpu_run(work):
    """Phase 1, the checks of phases 2, 3b and 3c, and phase 5, on two
    cores, while phase 5's CPU run (a cross-check, timed by nothing) goes
    on on the others from the start.  Returns the context, phase 2's
    errors and the inputs of the timed phases."""
    fg, bg = split_cores()
    every_core = os.sched_getaffinity(0)
    with ThreadPoolExecutor(1) as pool:
        t5 = time.perf_counter()
        small, cpu_run = start_crosscheck(work, pool, bg)
        os.sched_setaffinity(0, fg)
        try:
            ctx = phase_env()
            log(f"[phase 5] CPU run started on cores {sorted(bg)}; phases 1-3c's checks and phase 5 on CUDA "
                f"run on cores {sorted(fg)}")
            max_err = phase_exact(ctx)
            nw_inputs = phase_nw(ctx)
            phylo_inputs = phase_phylo(ctx)
            phase_crosscheck(work, small, cpu_run, t5)
        except BaseException:
            stop_cli_runs()  # or the pool would wait for the CPU run
            raise
        finally:
            os.sched_setaffinity(0, every_core)
    return ctx, max_err, nw_inputs, phylo_inputs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ctx, max_err, nw_inputs, phylo_inputs = checks_beside_cpu_run(work)
        # from here on nothing runs beside the timed phases
        timing = phase_times(ctx)
        phase_nw_times(ctx, nw_inputs)
        phase_phylo_times(ctx, phylo_inputs)
        launches = phase_slice(work)
    finally:
        stop_cli_runs()
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
