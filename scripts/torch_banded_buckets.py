#!/usr/bin/env python3
"""Count the banded pairs of chip_smoke.py phase 4's rescore per (LQ, LT, W)
bucket, on the host alone: no SW runs.

    python3 scripts/torch_banded_buckets.py

Writes phase 4's proteomes (synthetic.write_proteomes, 20 x 120, seed 7),
runs `createdb` (mock) on the CPU, the prefilter of `cluster`, and, in
place of the engine's first pass (the ungapped rescore of every candidate
pair), the banded pass's seeding of its long pairs (align/engine.py
`_banded_buckets`: the diagonal votes, the band width, the buckets).  Prints the pairs of
each bucket and the launches the plain route's 128 MB cap and the kernel
route's batch_size give.  The gapped passes score subsets of these pairs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Stop(Exception):
    pass


def main() -> int:
    os.environ["UNICORE_TPU_TORCH_DEVICE"] = "cpu"  # the engine's tensors stay on the host
    import chip_smoke as cs
    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.align import engine as E
    from unicore_tpu_torch.io.seqdb import SeqDB
    from unicore_tpu_torch.modules import cluster

    def count(self, entries, ungapped=False, counter="align", split_long=True):
        p = self.params
        long = [e for e in entries if max(len(e[1]), len(e[3])) > p.long_threshold]  # _sw_pass's split
        buckets = {k: len(v) for k, v in self._banded_buckets(long)[0].items()}
        launches = {route: sum(-(-n // E.banded_batch_size(p.batch_size, k[0], k[2], route == "kernel"))
                               for k, n in buckets.items()) for route in ("plain", "kernel")}
        print(json.dumps({"pass": "rescore (ungapped)", "candidate_pairs": len(entries),
                          "long_pairs": len(long), "launches": launches,
                          "buckets": [dict(LQ=k[0], LT=k[1], W=k[2], pairs=n) for k, n in sorted(buckets.items())]}))
        raise _Stop

    with tempfile.TemporaryDirectory() as work:
        in_dir, db = os.path.join(work, "in"), os.path.join(work, "db", "proteome_db")
        synthetic.write_proteomes(in_dir, cs.N_SPECIES, cs.PER_SPECIES, seed=7)
        env = dict(os.environ, HOME=work, UNICORE_TPU_TORCH_DEVICE="cpu", PYTHONPATH=ROOT)
        subprocess.run([sys.executable, "-m", "unicore_tpu_torch", "createdb", in_dir, db, "mock"],
                       check=True, env=env, capture_output=True)
        E.AlignmentEngine._sw_pass = count
        try:
            cluster.cluster_db(SeqDB.read(db, require_ss=True), E.AlignParams.from_options(""))
        except _Stop:
            return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
