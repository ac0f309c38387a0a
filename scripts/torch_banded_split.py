#!/usr/bin/env python3
"""Phase 4's main path (chip_smoke.py: createdb mock -> cluster -> profile
-> tree -n on 20 x 120 synthetic proteomes) in several trees of the repo
in one run on one NVIDIA GPU, to read the banded pass's time before and
after a change.

    python3 scripts/torch_banded_split.py [--parent DIR] [--out FILE]

Trees, each run in its own process with its own build of the kernels,
in turns: with --parent, "parent" (an unpacked older commit: `git archive
<commit> | tar -x -C DIR`) and "kernel" (this checkout) in the order
parent, kernel, kernel, parent; without it, "plain" (a copy of this
checkout whose engine sends the banded batches to the plain version,
ops/banded.py, on the card, as before the banded kernel: the counters
split the plain path's time) and "kernel" in the order plain, kernel,
kernel, plain.  Each tree's kernels are built before the first run.
Each run prints the stage walls, banded.seconds and its split
(banded.seed|pack|device.seconds, where the tree has them), the banded
batches, pairs and buckets and the kernels' launches; every file the
chain writes (the DB, clust.tsv, the profile, the MSAs, the supermatrix
and its partition file) must be byte-identical to the first run's.

Then one traced run per tree, in the same order (parent or plain, then
kernel): `createdb` as above, then `cluster` in the driver's process under
torch.profiler (CUDA activity alone).  It prints the banded kernel's
launches and summed device time from the trace (events named
`banded_kernel`), the device time of every kernel of the stage, the
stage's wall and the device's idle share (1 - device time / wall); its
DB and clust.tsv must equal the timed runs'.  JSON lines go to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run inside a tree: phase 4's inputs and CLI chain (chip_smoke.run_slice)
DRIVER = r"""
import hashlib, json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as c
from unicore_tpu_torch import synthetic
work = tempfile.mkdtemp(prefix="banded_split_")
in_dir, out_dir = os.path.join(work, "proteomes"), os.path.join(work, "main")
synthetic.write_proteomes(in_dir, c.N_SPECIES, c.PER_SPECIES, seed=7)
times, counters = c.run_slice(in_dir, out_dir, os.path.join(work, "home"))
files = {k: hashlib.sha256(v).hexdigest() for k, v in c.read_files(out_dir).items()}
print("RESULT " + json.dumps(dict(times=times, cluster=counters["cluster"], files=files)))
"""

KEYS = ("banded.seconds", "banded.seed.seconds", "banded.pack.seconds", "banded.device.seconds",
        "banded.launches", "banded.pairs", "banded.buckets", "kernel.banded.gapped.launches",
        "kernel.banded.ungapped.launches", "kernel.sw.gapped.launches", "kernel.sw.ungapped.launches",
        "align.seconds", "rescore.seconds", "align.cells", "rescore.cells", "stage.cluster.seconds",
        "cluster.candidate_pairs", "cluster.hits", "cluster.clusters")
PLAIN_CALL = "res = sw_forward_banded_cuda(*arrays, self._saa_t, self._s3d_t, qc=qct, **kw)"


def plain_tree(dst: str) -> str:
    """A copy of this checkout's package and chip_smoke.py whose engine
    calls the plain banded version on the device."""
    for name in ("unicore_tpu_torch", "chip_smoke.py"):
        src = os.path.join(ROOT, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(src, dst)
    path = os.path.join(dst, "unicore_tpu_torch", "align", "engine.py")
    text = open(path).read()
    if text.count(PLAIN_CALL) != 1:
        raise SystemExit("torch_banded_split: the engine's banded call is not where expected")
    text = text.replace(PLAIN_CALL, "from unicore_tpu_torch.ops.banded import sw_forward_banded\n"
                        "                    " + PLAIN_CALL.replace("sw_forward_banded_cuda", "sw_forward_banded"))
    open(path, "w").write(text)
    return dst


# run inside a tree: build its kernels, so that no run's counters hold a build
BUILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
for mod in (sw_cuda, banded_cuda, dirbits_cuda):
    mod.build()
"""


# run inside a tree: phase 4's createdb, then its cluster stage in process
# under torch.profiler; every device event's (count, ns) by name
TRACED = r"""
import hashlib, json, os, sys, tempfile, time
work = tempfile.mkdtemp(prefix="banded_trace_")
os.environ["HOME"] = os.path.join(work, "home")  # a fresh E-value fit, as run_slice's
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from unicore_tpu_torch import cli, synthetic
in_dir, out_dir = os.path.join(work, "proteomes"), os.path.join(work, "main")
synthetic.write_proteomes(in_dir, c.N_SPECIES, c.PER_SPECIES, seed=7)
db = os.path.join(out_dir, "proteome", "proteome_db")
c.run_steps([("createdb", ["createdb", in_dir, db, "mock"])], out_dir, os.environ["HOME"])
cfile = os.path.join(work, "cluster.counters.json")
os.environ["UNICORE_TPU_TORCH_COUNTERS"] = cfile
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    rc = cli.main(["cluster", db, os.path.join(out_dir, "cluster", "clust"), os.path.join(out_dir, "tmp"),
                   "-v", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
assert rc == 0, f"cluster exited {rc}"
names = {}
for e in prof.profiler.kineto_results.events():
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        n, ns = names.get(e.name(), (0, 0))
        names[e.name()] = (n + 1, ns + e.duration_ns())
files = {k: hashlib.sha256(v).hexdigest() for k, v in c.read_files(out_dir).items()}
print("RESULT " + json.dumps(dict(wall=wall, names=names, cluster=json.load(open(cfile)), files=files)))
"""


def traced_row(name: str, r: dict, smi: str) -> dict:
    """The trace's banded kernel, every kernel by device time, the wall
    and the idle share."""
    banded = [v for k, v in r["names"].items() if "banded_kernel" in k]
    busy_ns = sum(ns for _, ns in r["names"].values())
    top = sorted(r["names"].items(), key=lambda kv: -kv[1][1])[:8]
    return dict(traced=True, tree=name, card=smi, wall_s=r["wall"],
                banded_kernel_launches=sum(n for n, _ in banded),
                banded_kernel_device_s=sum(ns for _, ns in banded) / 1e9,
                device_busy_s=busy_ns / 1e9, idle_share=1 - busy_ns / 1e9 / r["wall"],
                top_kernels=[(k[:80], n, ns / 1e9) for k, (n, ns) in top],
                **{k: r["cluster"].get(k) for k in KEYS})


def run(name: str, tree: str, driver: str = DRIVER) -> dict:
    res = subprocess.run([sys.executable, "-c", driver], cwd=tree, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"torch_banded_split: {name} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="an unpacked older commit of the repo")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_banded_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        other = "parent" if opts.parent else "plain"
        trees = {"kernel": ROOT, other: os.path.abspath(opts.parent) if opts.parent
                 else plain_tree(os.path.join(tmp, "plain"))}
        order = [other, "kernel", "kernel", other]
        for name in set(order):
            subprocess.run([sys.executable, "-c", BUILD], cwd=trees[name], check=True)
        first = None
        out = open(opts.out, "w") if opts.out else None
        for n, name in enumerate(order):
            r = run(name, trees[name])
            first = first or r["files"]
            if r["files"] != first:
                diff = sorted(k for k in set(first) | set(r["files"]) if first.get(k) != r["files"].get(k))
                raise SystemExit(f"torch_banded_split: run {n} ({name}) wrote other files: {diff[:10]}")
            row = dict(run=n, tree=name, card=smi, times=r["times"],
                       **{k: r["cluster"].get(k) for k in KEYS})
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
        for name in (other, "kernel"):
            r = run(name, trees[name], TRACED)
            diff = sorted(k for k in r["files"] if first.get(k) != r["files"][k])
            if diff:
                raise SystemExit(f"torch_banded_split: traced {name} wrote other files: {diff[:10]}")
            row = traced_row(name, r, smi)
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
        if out:
            out.close()
    print(f"torch_banded_split: {len(order)} runs, their {len(first)} files byte-identical; "
          "2 traced", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
