#!/usr/bin/env python3
"""Phase 4's main path and phase 7a's search (chip_smoke.py: createdb mock
-> cluster -> profile -> tree -n on 20 x 120 synthetic proteomes, then
`search` of one reference per core gene against them) in two trees of the
repo, in turns in one run on one NVIDIA GPU, to read the NW forward's and
the m8 traceback's times before and after a change.

    python3 scripts/torch_dirbits_split.py --parent DIR [--out FILE]

Trees, each run in its own process with its own build of the kernels:
"parent" (an unpacked older commit: `git archive <commit> | tar -x -C
DIR`) and "change" (this checkout), in the order parent, change, change,
parent; each tree's kernels are built before the first run.  Each run
prints the stage walls, the MSA's counters (msa.seconds, msa.nw.seconds,
msa.dispatches), the traceback's (traceback.fill_seconds,
traceback.seconds, traceback.dispatches) and the direction-bit kernel's
launches where the tree has it; every file the chain and the search write
(the DB, clust.tsv, the profile, the MSAs, the supermatrix and its
partition file, the m8) must be byte-identical to the first run's.
Then one traced run per tree (parent, then change): createdb, cluster and
profile as above, then `tree -n` and the search each in the run's own
process under torch.profiler (CUDA activity alone).  For each of the two
stages it prints the direction-bit kernel's launches and summed device
time from the trace (events named `dirbits_kernel`), the device time of
the stage's busiest kernels, the stage's wall and the device's idle share
(1 - device time / wall); its files must equal the timed runs'.  JSON
lines go to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run inside a tree: phase 4's inputs and CLI chain (chip_smoke.run_slice),
# then phase 7a's search (chip_smoke.phase_search's steps)
DRIVER = r"""
import hashlib, json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as c
from unicore_tpu_torch import synthetic
work = tempfile.mkdtemp(prefix="dirbits_split_")
in_dir, out_dir = os.path.join(work, "proteomes"), os.path.join(work, "main")
synthetic.write_proteomes(in_dir, c.N_SPECIES, c.PER_SPECIES, seed=7)
times, counters = c.run_slice(in_dir, out_dir, os.path.join(work, "home"))
db = os.path.join(out_dir, "proteome", "proteome_db")
s_dir = os.path.join(work, "search7a")
ref = os.path.join(s_dir, "ref", "ref_db")
c.write_reference_db(db, c.core_genes(out_dir), ref)
m8 = os.path.join(s_dir, "search", "search")
t2, c2 = c.run_steps([("search", ["search", db, ref, m8, os.path.join(s_dir, "tmp"), "-s", c.SEARCH_OPTIONS])],
                     s_dir, os.path.join(work, "home"))
times.update(t2)
files = {k: hashlib.sha256(v).hexdigest() for k, v in c.read_files(out_dir).items()}
files["search.m8"] = hashlib.sha256(open(m8 + ".m8", "rb").read()).hexdigest()
print("RESULT " + json.dumps(dict(times=times, tree=counters["tree"], search=c2["search"], files=files)))
"""

# run inside a tree: build its kernels, so that no run's counters hold a build
BUILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
for mod in (sw_cuda, banded_cuda, dirbits_cuda):
    mod.build()
"""

# run inside a tree: phase 4's createdb, cluster and profile as subprocesses,
# then its tree -n and phase 7a's search in this process, each under
# torch.profiler; every device event's (count, ns) by name, per stage
TRACED = r"""
import hashlib, json, os, sys, tempfile, time
work = tempfile.mkdtemp(prefix="dirbits_trace_")
os.environ["HOME"] = os.path.join(work, "home")  # a fresh E-value fit, as run_slice's
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from unicore_tpu_torch import cli, synthetic
in_dir, out_dir = os.path.join(work, "proteomes"), os.path.join(work, "main")
synthetic.write_proteomes(in_dir, c.N_SPECIES, c.PER_SPECIES, seed=7)
db = os.path.join(out_dir, "proteome", "proteome_db")
c.run_steps([("createdb", ["createdb", in_dir, db, "mock"]),
             ("cluster", ["cluster", db, os.path.join(out_dir, "cluster", "clust"), os.path.join(out_dir, "tmp")]),
             ("profile", ["profile", db, os.path.join(out_dir, "cluster", "clust.tsv"),
                          os.path.join(out_dir, "profile")])], out_dir, os.environ["HOME"])
s_dir = os.path.join(work, "search7a")
ref, m8 = os.path.join(s_dir, "ref", "ref_db"), os.path.join(s_dir, "search", "search")

def traced(argv, name):
    from unicore_tpu_torch.ops import banded_cuda, dirbits_cuda, sw_cuda
    from unicore_tpu_torch.runtime import profiling
    profiling.reset_counters()
    for mod in (sw_cuda, banded_cuda, dirbits_cuda):
        mod.reset_launch_counts()
    os.environ["UNICORE_TPU_TORCH_COUNTERS"] = os.path.join(work, name + ".counters.json")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main([*argv, "-v", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert rc == 0, f"{name} exited {rc}"
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, ns = names.get(e.name(), (0, 0))
            names[e.name()] = (n + 1, ns + e.duration_ns())
    return dict(wall=wall, names=names, counters=json.load(open(os.environ["UNICORE_TPU_TORCH_COUNTERS"])))

stages = {"tree": traced(["tree", db, os.path.join(out_dir, "profile"), os.path.join(out_dir, "tree"), "-n"], "tree")}
c.write_reference_db(db, c.core_genes(out_dir), ref)
stages["search"] = traced(["search", db, ref, m8, os.path.join(s_dir, "tmp"), "-s", c.SEARCH_OPTIONS], "search")
files = {k: hashlib.sha256(v).hexdigest() for k, v in c.read_files(out_dir).items()}
files["search.m8"] = hashlib.sha256(open(m8 + ".m8", "rb").read()).hexdigest()
print("RESULT " + json.dumps(dict(stages=stages, files=files)))
"""

TREE_KEYS = ("msa.seconds", "msa.nw.seconds", "msa.dispatches", "msa.cells", "kernel.dirbits.nw.launches",
             "stage.tree.seconds")
SEARCH_KEYS = ("traceback.fill_seconds", "traceback.seconds", "traceback.dispatches", "traceback.batched",
               "kernel.dirbits.sw_bits.launches", "search.hits", "stage.search.seconds")


def traced_row(name: str, stage: str, r: dict, smi: str) -> dict:
    """The trace's direction-bit kernel, the stage's busiest kernels, its
    wall and the device's idle share."""
    dirbits = [v for k, v in r["names"].items() if "dirbits_kernel" in k]
    busy_ns = sum(ns for _, ns in r["names"].values())
    top = sorted(r["names"].items(), key=lambda kv: -kv[1][1])[:8]
    keys = TREE_KEYS if stage == "tree" else SEARCH_KEYS
    return dict(traced=True, tree=name, stage=stage, card=smi, wall_s=r["wall"],
                dirbits_kernel_launches=sum(n for n, _ in dirbits),
                dirbits_kernel_device_s=sum(ns for _, ns in dirbits) / 1e9,
                device_busy_s=busy_ns / 1e9, idle_share=1 - busy_ns / 1e9 / r["wall"],
                top_kernels=[(k[:80], n, ns / 1e9) for k, (n, ns) in top],
                **{k: r["counters"].get(k) for k in keys})


def run(name: str, tree: str, code: str = DRIVER) -> dict:
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"torch_dirbits_split: {name} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked older commit of the repo")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dirbits_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(opts.parent), "change": ROOT}
    order = ["parent", "change", "change", "parent"]
    for name in trees:
        subprocess.run([sys.executable, "-c", BUILD], cwd=trees[name], check=True)
    first = None
    rows = []
    for n, name in enumerate(order):
        r = run(name, trees[name])
        first = first or r["files"]
        if r["files"] != first:
            diff = sorted(k for k in set(first) | set(r["files"]) if first.get(k) != r["files"].get(k))
            raise SystemExit(f"torch_dirbits_split: run {n} ({name}) wrote other files: {diff[:10]}")
        row = dict(run=n, tree=name, card=smi, times=r["times"], **{k: r["tree"].get(k) for k in TREE_KEYS},
                   **{k: r["search"].get(k) for k in SEARCH_KEYS})
        print(json.dumps(row), flush=True)
        rows.append(row)
    for name in ("parent", "change"):
        r = run(name, trees[name], TRACED)
        diff = sorted(k for k in set(first) | set(r["files"]) if first.get(k) != r["files"].get(k))
        if diff:
            raise SystemExit(f"torch_dirbits_split: traced {name} wrote other files: {diff[:10]}")
        for stage in ("tree", "search"):
            row = traced_row(name, stage, r["stages"][stage], smi)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if opts.out:
        with open(opts.out, "w") as out:
            out.writelines(json.dumps(row) + "\n" for row in rows)
    print(f"torch_dirbits_split: {len(order)} runs, their {len(first)} files byte-identical; 2 traced",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
