"""ProstT5 training and prediction across torch.distributed ranks
(parallel/mesh.py's process_mesh, parallel/collectives.py,
parallel/sharding.py's RankShardedProstT5) against the JAX package's
make_train_step and make_sharded_predict on its 8 virtual devices, on
the CPU.

Every case starts real processes of `python -m
unicore_tpu_torch.parallel.dist_check` over gloo (one torch thread
each), as tests/test_torch_distributed.py does: each rank holds its tp
slice of tests/test_torch_train.py's 2-layer state and its block of its
ragged batch, and rank 0 writes the losses, the first step's gradients
and the parameters after the last step, gathered whole.  They are held
against JAX's sharded step at the same (dp, tp) and against the
one-process ShardedProstT5, with tests/test_torch_train.py's tolerances
and Adam rule (imported from it).  Each rank checks that the replicated
leaves are bit-identical on every rank after the steps.  Every
subprocess has a timeout.

The states are drawn from seeds 100 + 10 dp + tp, not test_torch_train.py's
10 dp + tp: at seed 22, relu at (dp, tp) = (2, 2), the port's sharded
step (the one-process ShardedProstT5 as the ranks) gives one layers.0.v
entry whose gradient is 1e-7 of max|g|, float noise, the other sign than
JAX's, Adam's first step moves it 2 lr the other way, and the second
step's embed updates leave the Adam rule (1.99 of its tolerance) while
the losses and gradients hold.  The ranks equal the one-process model
there under every check; of the (seed, ff) pairs 20-29 x relu,
gated-gelu that one alone does this."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_train import (  # noqa: F401  (J is a fixture)
    DIMS, LR, J, _batch, _init, _jax_loss_grads, _jax_steps, _port_steps, assert_grads_close,
    assert_losses_close, assert_updates_close,
)
from unicore_tpu_torch import graft_entry
from unicore_tpu_torch.convert import prostt5_from_jax, prostt5_to_jax
from unicore_tpu_torch.parallel import dist_check
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
RANK_TIMEOUT_S = 60  # a rank's own --timeout
WAIT_S = 120         # communicate(timeout=) of a rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(n, args, ranks=None, port=None):
    """Processes of dist_check --device cpu for `ranks` (default all n) of
    a world of n, over gloo on `port` (default a free one)."""
    env = dict(os.environ, PYTHONPATH=REPO, UNICORE_TPU_COORDINATOR=f"127.0.0.1:{port or _free_port()}",
               UNICORE_TPU_NUM_PROCS=str(n), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "unicore_tpu_torch.parallel.dist_check", "--device", "cpu", *map(str, args)],
        env=dict(env, UNICORE_TPU_PROC_ID=str(rank)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in (ranks or range(n))]


def finish_ranks(procs):
    """Each process's output once it has exited; raises where one failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return [[line for line in out.splitlines() if line.startswith("OK ")][-1] for out in outs]


def write_inputs(tmp_path, params, tokens, mask, labels=None):
    state = prostt5_from_jax(params)
    np.savez(tmp_path / "state.npz", **{k: v.numpy() for k, v in state.items()})
    extra = {} if labels is None else dict(labels=labels)
    np.savez(tmp_path / "batch.npz", tokens=tokens, mask=mask, **extra)
    return ["--state", tmp_path / "state.npz", "--batch", tmp_path / "batch.npz", "--out", tmp_path / "out.npz"]


def jax_places(J, dp, tp):
    """{process: (d, t)} where JAX's make_mesh puts each process's device,
    one device per process in process order (the virtual devices stand
    for the processes' devices)."""
    devs = J["mesh"].make_mesh(n_devices=dp * tp, dp=dp, tp=tp).devices
    ids = [d.id for d in J["jax"].devices()[:dp * tp]]
    return {ids.index(devs[d, t].id): (d, t) for d in range(dp) for t in range(tp)}


def test_widths_are_the_training_tests_dims():
    assert dict(dist_check.WIDTHS["test"], n_layers=2) == DIMS


@pytest.mark.parametrize("dp,tp,ff", [(2, 1, "relu"), (1, 2, "relu"), (2, 2, "relu"), (2, 2, "gated-gelu")])
def test_rank_training_matches_jax_and_one_process(J, tmp_path, dp, tp, ff):
    """STEPS Adam steps over dp x tp gloo ranks: the losses, the first
    step's gradients and the updates against JAX's make_train_step at
    the same (dp, tp) and against ShardedProstT5 on a (dp, tp) mesh of
    CPU shards in one process."""
    jcfg, cfg, params = _init(J, ff, seed=100 + dp * 10 + tp)
    batch = _batch(dp + tp, 4 * dp, 32)
    args = write_inputs(tmp_path, params, *batch)
    procs = start_ranks(dp * tp, ["--train", f"{dp}x{tp}", "--width", "test", "--layers", 2, "--ff", ff,
                                  "--steps", STEPS, "--lr", LR, "--timeout", RANK_TIMEOUT_S, *args])
    try:  # the references while the ranks run
        _, g_ref = _jax_loss_grads(J, jcfg, params, batch)
        losses_ref, p_ref = _jax_steps(J, jcfg, params, batch, STEPS, dp, tp)
        mesh = mesh_mod.make_mesh(devices=["cpu"] * (dp * tp), dp=dp, tp=tp)
        one = sharding.shard_params(prostt5_from_jax(params), mesh)
        losses_1, grads_1 = _port_steps(one, cfg, batch, STEPS, mesh)
    finally:
        lines = finish_ranks(procs)
    assert len({line.split(" loss=")[1].split()[0] for line in lines}) == 1, lines  # one loss on every rank
    assert all(line.endswith("replicated=identical") for line in lines), lines
    with np.load(tmp_path / "out.npz") as z:
        losses = list(z["loss"])
        grads = {k[5:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("grad/")}
        after = {k[6:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("param/")}
        coords = z["coords"]
    places = jax_places(J, dp, tp)
    assert [tuple(c) for c in coords] == [places[r] for r in range(dp * tp)]
    assert_losses_close(losses_ref, losses)
    assert_losses_close(losses_1, losses)
    assert_grads_close(g_ref, prostt5_to_jax(grads))
    assert_grads_close(prostt5_to_jax(grads_1), prostt5_to_jax(grads))
    assert_updates_close(params, p_ref, prostt5_to_jax(after), g_ref, STEPS)
    assert_updates_close(params, prostt5_to_jax(one), prostt5_to_jax(after), g_ref, STEPS)


def test_rank_predict_matches_jax(J, tmp_path):
    """make_sharded_predict over 2 gloo ranks at tp = 2, float32: JAX's
    codes on its (1, 2) mesh under graft_entry.same_codes's tie rule."""
    jnp = J["jnp"]
    jcfg, _, _ = _init(J, "relu")
    params = J["P"].init_params(jcfg, seed=5, dtype=jnp.float32)
    tokens, mask, _ = _batch(7, 4, 64)
    procs = start_ranks(2, ["--predict", "1x2", "--width", "test", "--layers", 2, "--timeout", RANK_TIMEOUT_S,
                            *write_inputs(tmp_path, params, tokens, mask)])
    try:
        jmesh = J["mesh"].make_mesh(n_devices=2, dp=1, tp=2)
        with jmesh:
            ref = np.asarray(J["sh"].make_sharded_predict(jcfg, jmesh)(
                J["sh"].shard_params(params, jmesh), jnp.asarray(tokens), jnp.asarray(mask)))
        logits = np.asarray(J["P"].residue_logits(params, jcfg, jnp.asarray(tokens), jnp.asarray(mask)), np.float32)
    finally:
        finish_ranks(procs)
    with np.load(tmp_path / "out.npz") as z:
        got = z["codes"]
    assert got.shape == ref.shape
    graft_entry.same_codes(ref, got, logits, "tp = 2 predict over 2 ranks")


@pytest.mark.parametrize("peer", ["never starts", "dies"])
def test_rank_without_its_peer_fails_within_its_timeout(tmp_path, peer):
    """Rank 0 of a world of 2 whose rank 1 never starts, or joins the
    group and dies (a --state it cannot read), exits non-zero after its
    --timeout, and does not hang."""
    args, port = ["--train", "1x2", "--timeout", 3], _free_port()
    t0 = time.perf_counter()
    procs = start_ranks(2, args, ranks=[0], port=port)
    if peer == "dies":
        procs += start_ranks(2, args + ["--state", tmp_path / "missing.npz"], ranks=[1], port=port)
    try:
        outs = [p.communicate(timeout=WAIT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode != 0 for p in procs), outs
    assert time.perf_counter() - t0 < 60, outs
    if peer == "dies":
        assert "missing.npz" in outs[1], outs[1]


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_process_mesh_places_ranks_like_jax(J, dp, tp):
    """Each of 8 ranks (one process at a time, as each rank of a fake
    process group) at the (d, t) where JAX's make_mesh puts that
    process's device, with the ranks of its mesh row as its tp group and
    of its column as its dp group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    places = jax_places(J, dp, tp)
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        try:
            pm = mesh_mod.process_mesh(dp, tp, device="cpu")
            d, t = places[rank]
            assert (pm.d, pm.t, pm.shape) == (d, t, {"dp": dp, "tp": tp})
            assert dist.get_process_group_ranks(pm.tp_group) == sorted(r for r, p in places.items() if p[0] == d)
            assert dist.get_process_group_ranks(pm.dp_group) == sorted(r for r, p in places.items() if p[1] == t)
            with pytest.raises(ValueError, match="process mesh 3x3"):
                mesh_mod.process_mesh(3, 3, device="cpu")
        finally:
            dist.destroy_process_group()


def test_rank_model_refuses_a_leaf_without_a_reduction_rule():
    """Every leaf of a RankShardedProstT5 has a GRAD_REDUCE entry, the split
    ones "dp"; a state with a leaf the table lacks is refused (rank 0 of
    a fake process group of 4)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from unicore_tpu_torch.models import prostt5 as T

    state = T.init_params(T.T5Config(**DIMS), 0, torch.float32)
    specs = sharding.param_pspecs(state)
    assert all(sharding.GRAD_REDUCE[sharding._leaf_name(n)] == "dp" for n, s in specs.items() if s)
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=4)
    try:
        pm = mesh_mod.process_mesh(2, 2, device="cpu")
        model = sharding.shard_params(state, pm)
        assert torch.equal(model.leaf("encoder.blocks.1.wo.weight"), state["encoder.blocks.1.wo.weight"][:, 64:])
        assert torch.equal(model.leaf("encoder.blocks.0.q.weight"), state["encoder.blocks.0.q.weight"][32:])
        with pytest.raises(ValueError, match="no gradient reduction rule for \\['extra'\\]"):
            sharding.shard_params(dict(state, **{"head.extra.weight": torch.zeros(2)}), pm)
    finally:
        dist.destroy_process_group()
