"""Check of the multi-process bring-up: one rank of a torch.distributed run.

    UNICORE_TPU_COORDINATOR=localhost:PORT UNICORE_TPU_NUM_PROCS=2 UNICORE_TPU_PROC_ID=R \\
        python -m unicore_tpu_torch.parallel.dist_check [--device cuda|cpu]

Run once per rank, each with its own UNICORE_TPU_PROC_ID (the port's
counterpart of the JAX package's tests/dist_worker.py).  Every rank
brings the process group up through `initialize_distributed`, makes the
same seeded SW pair batch, holds only its own block of pairs and scores
it through `sw_forward_cuda` on `--device` (the kernel on a card, the
plain version on the CPU); the ranks all-reduce the number of pairs
above HIT_SCORE and all-gather (best, qend, tend), and each checks both
against the whole batch scored locally by the plain version.  On the
gloo backend the collectives run on host copies.  A rank whose peer
never comes fails after TIMEOUT_S.  Prints
"OK procs=N backend=B hits=H launches=L" and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

B, L = 64, 128    # pairs and length of the batch, split over the ranks
HIT_SCORE = 300.0  # a "hit": best above this (planted homologs pass it)
SEED = 20261017
TIMEOUT_S = 120.0


def batch(seed: int = SEED):
    """The seeded batch: random AA/3Di codes, every other pair a planted
    copy of its query with substitutions."""
    rng = np.random.RandomState(seed)
    qa, qs, ta, ts = (rng.randint(0, 20, (B, L)).astype(np.int32) for _ in range(4))
    ql = rng.randint(L // 2, L + 1, B).astype(np.int32)
    tl = rng.randint(L // 2, L + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        ta[b], ts[b] = qa[b], qs[b]
        sub = rng.randint(0, L, L // 8)
        ta[b, sub] = rng.randint(0, 20, len(sub))
    return qa, qs, ta, ts, ql, tl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain
    from unicore_tpu_torch.parallel.mesh import initialize_distributed

    backend = initialize_distributed(timeout_s=TIMEOUT_S, backend="gloo" if args.device == "cpu" else None)
    if backend is None:
        raise SystemExit("dist_check: UNICORE_TPU_COORDINATOR is not set")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if B % world:
            raise SystemExit(f"dist_check: {B} pairs do not split over {world} ranks")
        dev = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
               else torch.device("cpu"))
        comm = dev if backend == "nccl" else torch.device("cpu")
        arrays = [torch.from_numpy(x) for x in batch()]
        saa = torch.from_numpy(get_aa_matrix().astype(np.float32))
        s3d = torch.from_numpy(get_3di_matrix().astype(np.float32))
        per = B // world
        mine = [x[rank * per:(rank + 1) * per].contiguous().to(dev) for x in arrays]
        sw_cuda.reset_launch_counts()
        # the engine's gapped forward (gap_window 64) on this rank's block
        best, qend, tend = sw_cuda.sw_forward_cuda(*mine, saa.to(dev), s3d.to(dev), gap_window=64)

        hits = (best > HIT_SCORE).sum().to(torch.int64).reshape(1).to(comm)
        dist.all_reduce(hits)
        gathered = []
        for t in (best, qend, tend):
            parts = [torch.empty_like(t, device=comm) for _ in range(world)]
            dist.all_gather(parts, t.to(comm))
            gathered.append(torch.cat(parts).cpu())

        ref = sw_forward_plain(*arrays, saa, s3d, gap_window=64)
        for name, r, g in zip(("best", "qend", "tend"), ref, gathered):
            if not torch.equal(r, g):
                raise AssertionError(f"rank {rank}: gathered {name} != the local reference")
        want = int((ref[0] > HIT_SCORE).sum())
        if int(hits.item()) != want:
            raise AssertionError(f"rank {rank}: all-reduced hits {int(hits.item())} != {want}")
        dist.barrier()
        print(f"OK procs={world} backend={backend} hits={want} "
              f"launches={sw_cuda.LAUNCHES['gapped']}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
