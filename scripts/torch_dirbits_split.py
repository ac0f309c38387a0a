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
parent.  Each run prints the stage walls, the MSA's counters
(msa.seconds, msa.nw.seconds, msa.dispatches), the traceback's
(traceback.fill_seconds, traceback.seconds, traceback.dispatches) and the
direction-bit kernel's launches where the tree has it; every file the
chain and the search write (the DB, clust.tsv, the profile, the MSAs, the
supermatrix and its partition file, the m8) must be byte-identical to the
first run's.  JSON lines go to --out.
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

TREE_KEYS = ("msa.seconds", "msa.nw.seconds", "msa.dispatches", "msa.cells", "kernel.dirbits.nw.launches",
             "stage.tree.seconds")
SEARCH_KEYS = ("traceback.fill_seconds", "traceback.seconds", "traceback.dispatches", "traceback.batched",
               "kernel.dirbits.sw_bits.launches", "search.hits", "stage.search.seconds")


def run(name: str, tree: str) -> dict:
    res = subprocess.run([sys.executable, "-c", DRIVER], cwd=tree, capture_output=True, text=True)
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
    if opts.out:
        with open(opts.out, "w") as out:
            out.writelines(json.dumps(row) + "\n" for row in rows)
    print(f"torch_dirbits_split: {len(order)} runs, their {len(first)} files byte-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
