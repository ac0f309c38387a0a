#!/usr/bin/env python3
"""Phase 4's main path (chip_smoke.py: createdb mock -> cluster -> profile
-> tree -n on 20 x 120 synthetic proteomes) in several trees of the repo
in one run on one NVIDIA GPU, to read the banded pass's time before and
after a change.

    python3 scripts/torch_banded_split.py [--parent DIR] [--out FILE]

Trees, each run in its own process with its own build of the kernels,
in turns: "parent" (an unpacked older commit, if given: `git archive
<commit> | tar -x -C DIR`), "plain" (a copy of this checkout whose engine
sends the banded batches to the plain version, ops/banded.py, on the
card, as before the banded kernel: the counters split the plain path's
time) and "kernel" (this checkout), in the order parent, plain, kernel,
kernel, plain.  Each run prints the stage walls, banded.seconds and its
split (banded.seed|pack|device.seconds, where the tree has them), the
banded batches and the kernels' launches; every file the chain writes
(the DB, clust.tsv, the profile, the MSAs, the supermatrix and its
partition file) must be byte-identical to the first run's.  JSON lines
go to --out.
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
        "banded.launches", "kernel.banded.gapped.launches", "kernel.banded.ungapped.launches",
        "kernel.sw.gapped.launches", "kernel.sw.ungapped.launches", "align.seconds", "rescore.seconds",
        "stage.cluster.seconds", "cluster.candidate_pairs", "cluster.hits", "cluster.clusters")
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


def run(name: str, tree: str) -> dict:
    res = subprocess.run([sys.executable, "-c", DRIVER], cwd=tree, capture_output=True, text=True)
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
        trees = {"plain": plain_tree(os.path.join(tmp, "plain")), "kernel": ROOT}
        order = ["plain", "kernel", "kernel", "plain"]
        if opts.parent:
            trees["parent"] = os.path.abspath(opts.parent)
            order.insert(0, "parent")
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
        if out:
            out.close()
    print(f"torch_banded_split: {len(order)} runs, their {len(first)} files byte-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
