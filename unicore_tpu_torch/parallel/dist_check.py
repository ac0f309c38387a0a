"""Check of the multi-process bring-up: one rank of a torch.distributed run.

    UNICORE_TPU_COORDINATOR=localhost:PORT UNICORE_TPU_NUM_PROCS=N UNICORE_TPU_PROC_ID=R \\
        python -m unicore_tpu_torch.parallel.dist_check [--device cuda|cpu]
            [--train DPxTP | --predict DPxTP] [options of those modes]

Run once per rank, each with its own UNICORE_TPU_PROC_ID (the port's
counterpart of the JAX package's tests/dist_worker.py).  Every rank
brings the process group up through `initialize_distributed`; a rank
whose peer never comes, or dies, fails after --timeout seconds
(TIMEOUT_S) instead of hanging.

SW mode (the default): every rank makes the same seeded SW pair batch,
holds only its own block of pairs and scores it through
`sw_forward_cuda` on `--device` (the kernel on a card, the plain version
on the CPU); the ranks all-reduce the number of pairs above HIT_SCORE
and all-gather (best, qend, tend), and each checks both against the
whole batch scored locally by the plain version.  On the gloo backend
the collectives run on host copies.  Prints "OK procs=N backend=B
hits=H launches=L" and exits 0, or raises.

Training mode (--train DPxTP, N = DP x TP ranks): each rank takes its
place in parallel/mesh.py's `process_mesh`, holds its part of a ProstT5
state (`--state` an npz in models/prostt5.py names, else drawn on its
device by synthetic.prostt5_train_state from --seed at --width and
--layers) as a RankShardedProstT5, and runs --steps Adam steps of
parallel/sharding.py's make_train_step at --lr on the whole batch
(`--batch` an npz of tokens, mask and labels, else a seeded one), of
which it computes its block.  It checks that the replicated leaves are
bit-identical on every rank after the steps.  With --out, rank 0 writes
the losses, each rank's (d, t), ms per step and peak memory, and the
first step's gradients ("grad/NAME") and the parameters after the last
("param/NAME"), gathered whole, as an npz.  Prints "OK procs=N
backend=B train=DPxTP rank=R d=D t=T loss=... ms=... peak_gib=...".

Predict mode (--predict DPxTP): make_sharded_predict over the process
mesh on --state and --batch's tokens and mask; rank 0 writes the codes
("codes") to --out.  Prints "OK procs=N backend=B predict=DPxTP".
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
WIDTHS = {  # T5Config fields of --width; "test" is tests/test_torch_train.py's DIMS
    "full": {},
    "test": dict(d_model=64, d_kv=8, n_heads=8, d_ff=128, cnn_hidden=16),
}


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


def sw_check(args, backend: str) -> None:
    """SW mode: this rank's block of the seeded batch, checked as the
    module docstring says."""
    import torch.distributed as dist

    from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
    from unicore_tpu_torch.ops import sw_cuda
    from unicore_tpu_torch.ops.sw import sw_forward_plain

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


def seeded_batch(B: int, L: int, seed: int):
    """(tokens, mask, labels) of B framed random proteins of ragged lengths
    (the first row full) in rows of L, labels uniform over the 20 3Di
    states."""
    from unicore_tpu_torch.models.prostt5 import frame_batch

    rng = np.random.RandomState(seed)
    lengths = [L - 2] + list(rng.randint(L // 4, L - 1, B - 1))
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) for n in lengths]
    tokens, mask = frame_batch(seqs, L, multiple=1)
    return tokens, mask, rng.randint(0, 20, (B, L))


def _mesh_shape(text: str):
    dp, tp = (int(x) for x in text.lower().split("x"))
    return dp, tp


def _load_npz(path: str):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def prostt5_check(args, backend: str) -> None:
    """Training or predict mode over a process mesh, as the module
    docstring says."""
    import time

    from unicore_tpu_torch import synthetic
    from unicore_tpu_torch.models.prostt5 import T5Config
    from unicore_tpu_torch.parallel import collectives as C
    from unicore_tpu_torch.parallel import sharding
    from unicore_tpu_torch.parallel.mesh import process_mesh

    dp, tp = _mesh_shape(args.train or args.predict)
    pm = process_mesh(dp, tp, device=args.device, timeout_s=args.timeout)
    cfg = T5Config(**WIDTHS[args.width], n_layers=args.layers, ff=args.ff)
    if args.state:
        state = {k: torch.from_numpy(v) for k, v in _load_npz(args.state).items()}
    else:
        state = synthetic.prostt5_train_state(cfg, args.seed, pm.device)
    model = sharding.shard_params(state, pm)
    del state
    data = _load_npz(args.batch) if args.batch else None
    tag = f"procs={pm.world} backend={backend}"

    if args.predict:
        run = sharding.make_sharded_predict(cfg, model, pm)
        codes = run(data["tokens"], data["mask"])
        if pm.rank == 0 and args.out:
            np.savez(args.out, codes=codes)
        print(f"OK {tag} predict={args.predict} rank={pm.rank} d={pm.d} t={pm.t}", flush=True)
        return

    tokens, mask, labels = ((data["tokens"], data["mask"], data["labels"]) if data
                            else seeded_batch(4 * dp, 128, args.seed))
    on_card = pm.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(pm.device)
    step, init_opt = sharding.make_train_step(cfg, pm, lr=args.lr)
    opt = init_opt(model)
    losses, ms, grads = [], [], None
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(step(model, opt, tokens, mask, labels))  # .item() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if grads is None and args.out:
            grads = sharding.gather_state(model, grad=True)
    peak = torch.cuda.max_memory_allocated(pm.device) / 2**30 if on_card else float("nan")

    host = pm.host_comm
    for name, spec in model.specs.items():
        if not spec:
            mine = model.leaf(name).detach()
            if not all(torch.equal(mine, x) for x in C.all_gather(mine, None, host)):
                raise AssertionError(f"rank {pm.rank}: replicated {name} differs across the ranks")
    per_rank = torch.tensor([pm.d, pm.t, float(np.mean(ms[1:] or ms)), peak], dtype=torch.float64,
                            device=pm.device)  # NCCL gathers only card tensors
    ranks = torch.stack(C.all_gather(per_rank, None, host)).cpu().numpy()
    params = sharding.gather_state(model) if args.out else None
    if pm.rank == 0 and args.out:
        np.savez(args.out, loss=np.asarray(losses), coords=ranks[:, :2].astype(np.int64), ms=ranks[:, 2],
                 peak_gib=ranks[:, 3], **{f"grad/{k}": v.numpy() for k, v in grads.items()},
                 **{f"param/{k}": v.numpy() for k, v in params.items()})
    print(f"OK {tag} train={args.train} rank={pm.rank} d={pm.d} t={pm.t} "
          f"loss={','.join(f'{x:.9g}' for x in losses)} ms={','.join(f'{x:.2f}' for x in ms)} "
          f"peak_gib={peak:.3f} replicated=identical", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", metavar="DPxTP", help="ProstT5 training over a DP x TP process mesh")
    mode.add_argument("--predict", metavar="DPxTP", help="ProstT5 3Di prediction over a DP x TP process mesh")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--width", default="test", choices=sorted(WIDTHS))
    ap.add_argument("--ff", default="relu", choices=("relu", "gated-gelu"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--state", help="npz of a ProstT5 state in models/prostt5.py names")
    ap.add_argument("--batch", help="npz of tokens, mask and labels (B, L)")
    ap.add_argument("--out", help="npz that rank 0 writes")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S, help="seconds any wait may take")
    args = ap.parse_args(argv)
    if args.predict and not (args.state and args.batch):
        ap.error("--predict needs --state and --batch")
    if args.steps < 1:
        ap.error("--steps must be at least 1")

    import torch.distributed as dist

    from unicore_tpu_torch.parallel.mesh import initialize_distributed

    backend = initialize_distributed(timeout_s=args.timeout, backend="gloo" if args.device == "cpu" else None)
    if backend is None:
        raise SystemExit("dist_check: UNICORE_TPU_COORDINATOR is not set")
    try:
        if args.train or args.predict:
            prostt5_check(args, backend)
        else:
            sw_check(args, backend)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
