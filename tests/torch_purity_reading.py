#!/usr/bin/env python3
"""Cluster purity of the synthetic proteomes of chip_smoke.py's phase 4,
on a subset, in three runs on the CPU:

1. `unicore_tpu` (the JAX reference): `createdb mock` and `cluster`;
2. `unicore_tpu_torch` on the CPU, the same two subcommands; its
   `clust.tsv` must be byte-identical to run 1's;
3. `unicore_tpu_torch` again, with the E-value null simulated from what
   the mock 3Di backend makes of random sequences (3Di = MockProstT5 of
   the null's random AA) in place of the published 3Di background.

    JAX_PLATFORMS=cpu python tests/torch_purity_reading.py [--keep 8]

The subset keeps, from phase 4's data (8 species x 480 proteins, seed 7),
every family and orphan whose id is a multiple of `--keep`, in all
species.  Each run has a HOME of its own, so each fits its E-value
statistics afresh.  Prints one JSON object: per run, the purity, the
clusters, the mixed clusters (more than one family) and the sequences
outside their cluster's majority family.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def subset(src_dir, dst_dir, labels, keep):
    os.makedirs(dst_dir)
    kept = {}
    for fn in sorted(os.listdir(src_dir)):
        lines = open(os.path.join(src_dir, fn)).read().split("\n")
        with open(os.path.join(dst_dir, fn), "w") as out:
            for hdr, seq in zip(lines[0::2], lines[1::2]):
                fam = labels[hdr[1:]]
                if abs(fam) % keep == 0:
                    out.write(f"{hdr}\n{seq}\n")
                    kept[hdr[1:]] = fam
    return kept


def mixing(out_dir, labels):
    from unicore_tpu_torch import synthetic

    purity, n_clusters = synthetic.cluster_purity(out_dir, labels)
    header = {}
    for line in open(os.path.join(out_dir, "proteome", "proteome_db.map")):
        name, _, hdr = line.rstrip("\n").split("\t")
        header.setdefault(name, hdr)
    fams = {}
    for line in open(os.path.join(out_dir, "cluster", "clust.tsv")):
        rep, mem = line.split()
        fams.setdefault(rep, []).append(labels[header[mem]])
    mixed = [m for m in fams.values() if len(set(m)) > 1]
    outside = sum(len(m) - max(np.unique(m, return_counts=True)[1]) for m in mixed)
    return dict(purity=purity, clusters=n_clusters, mixed_clusters=len(mixed),
                sequences_outside_majority=int(outside))


def run_cli(main, out_dir, in_dir, home):
    os.environ["HOME"] = home
    db = os.path.join(out_dir, "proteome", "proteome_db")
    assert main(["createdb", in_dir, db, "mock", "-v", "1"]) == 0
    assert main(["cluster", db, os.path.join(out_dir, "cluster", "clust"),
                 os.path.join(out_dir, "tmp"), "-v", "1"]) == 0


def mock_null(stats_mod):
    """_simulate_scores with 3Di made by the mock backend from the null's
    random AA (and AA uniform, as in the published-background null)."""
    from unicore_tpu_torch.alphabets import AA_ALPHABET, TDI_ALPHABET
    from unicore_tpu_torch.models.mock import MockProstT5

    mock = MockProstT5()
    lut = np.full(256, 20, np.int32)
    lut[np.frombuffer(TDI_ALPHABET.encode(), np.uint8)] = np.arange(len(TDI_ALPHABET))

    def tdi(aa):
        seqs = ["".join(AA_ALPHABET[c] for c in row) for row in aa]
        return np.stack([lut[np.frombuffer(s.encode(), np.uint8)] for s in mock.predict(seqs)])

    def simulate(score_fn, B, L, seed):
        rng = np.random.RandomState(seed)
        qa = rng.randint(0, 20, (B, L)).astype(np.int32)
        ta = rng.randint(0, 20, (B, L)).astype(np.int32)
        ln = np.full(B, L, np.int32)
        return np.asarray(score_fn(qa, tdi(qa), ta, tdi(ta), ln, ln), dtype=np.float64)

    stats_mod._simulate_scores = simulate


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keep", type=int, default=8)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["UNICORE_TPU_TORCH_DEVICE"] = "cpu"

    from unicore_tpu.cli import main as jax_main
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.align import stats as tstats
    from unicore_tpu_torch.cli import main as port_main

    work = tempfile.mkdtemp(prefix="purity_")
    labels = synthetic.write_proteomes(os.path.join(work, "full"), 8, 480, seed=7)
    in_dir = os.path.join(work, "in")
    labels = subset(os.path.join(work, "full"), in_dir, labels, args.keep)
    result = {"sequences": len(labels),
              "longer_than_1024": sum(1 for fn in os.listdir(in_dir)
                                      for s in open(os.path.join(in_dir, fn)).read().split("\n")[1::2]
                                      if len(s) > 1024)}
    runs = [("jax", jax_main, None), ("port_cpu", port_main, None),
            ("port_cpu_mock_null", port_main, mock_null)]
    for name, main_fn, patch in runs:
        if patch is not None:
            patch(tstats)
        out = os.path.join(work, name)
        run_cli(main_fn, out, in_dir, os.path.join(work, f"home_{name}"))
        result[name] = mixing(out, labels)
        print(name, result[name], flush=True)
    same = (open(os.path.join(work, "jax", "cluster", "clust.tsv"), "rb").read()
            == open(os.path.join(work, "port_cpu", "cluster", "clust.tsv"), "rb").read())
    result["port_clust_tsv_identical_to_jax"] = same
    print(json.dumps(result))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
