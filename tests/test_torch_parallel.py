"""The port's device meshes (parallel/mesh.py) and sharded ProstT5
inference (parallel/sharding.py, ProstT5Engine._dp_setup) against the
JAX package's, on the CPU: `factor_mesh` equal on a grid, `make_mesh`
over 8 CPU devices shaped as JAX's over its 8 virtual ones, and
float32 3Di codes of the sharded predict (tp = 1 and tp = 2) and of the
engine with local_mesh patched to 4 CPU shards equal to JAX's under the
tie rule (torch_port_helpers.assert_same_3di).  tests/test_torch_train.py
holds the rest of parallel/sharding.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prostt5 import _jax_unit_logits, _seqs
from torch_port_helpers import assert_same_3di, port_env, write_prostt5_checkpoint  # noqa: F401
from unicore_tpu.models import prostt5 as J
from unicore_tpu.parallel import mesh as jmesh
from unicore_tpu.parallel import sharding as jsharding
from unicore_tpu_torch.alphabets import TDI_ALPHABET
from unicore_tpu_torch.convert import prostt5_from_jax
from unicore_tpu_torch.models import prostt5 as T
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.parallel import sharding

TDI = np.frombuffer(TDI_ALPHABET.encode(), np.uint8)


@pytest.mark.parametrize("tp_max", [1, 2, 3, 4, 8, 16])
def test_factor_mesh_equals_jax(tp_max):
    for n in range(1, 65):
        assert mesh_mod.factor_mesh(n, tp_max) == jmesh.factor_mesh(n, tp_max), (n, tp_max)


@pytest.mark.parametrize("kw", [{}, dict(dp=8, tp=1), dict(dp=2, tp=4), dict(n_devices=4), dict(n_devices=6)])
def test_make_mesh_over_cpu_devices_shaped_as_jax(kw):
    ref = jmesh.make_mesh(**kw)
    got = mesh_mod.make_mesh(devices=["cpu"] * 8, **kw)
    assert got.axis_names == tuple(ref.axis_names) == ("dp", "tp")
    assert got.shape == dict(ref.shape)
    assert got.devices.size == ref.devices.size
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_refuses_a_bad_factorization():
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(devices=["cpu"] * 8, dp=3, tp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no devices"):
            mesh_mod.make_mesh()


def test_local_mesh_never_shards_the_cpu():
    """The CPU never shards, in either package; several cards do."""
    assert mesh_mod.local_mesh("cpu") is None
    assert mesh_mod.local_mesh(None) is None
    m = mesh_mod.local_mesh("cuda")
    if torch.cuda.device_count() > 1:
        assert m.axis_names == ("dp",) and m.devices.size == torch.cuda.device_count()
    else:
        assert m is None


def test_initialize_distributed_is_a_no_op_without_its_variables(monkeypatch):
    for v in (mesh_mod.ENV_COORDINATOR, mesh_mod.ENV_NUM_PROCS, mesh_mod.ENV_PROC_ID):
        monkeypatch.delenv(v, raising=False)
    assert mesh_mod.initialize_distributed() is None
    assert not torch.distributed.is_initialized()


def test_sharded_predict_matches_jax():
    """tests/test_parallel.py::test_sharded_predict_matches_single_device
    with tp = 1: the port's sharded predict over 4 CPU shards against
    JAX's single-device and sharded predictions."""
    cfg = J.T5Config(d_model=128, d_kv=16, n_heads=8, d_ff=256, n_layers=2)
    params = J.init_params(cfg, seed=0, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 20, (8, 128)).astype(np.int32)
    mask = np.ones((8, 128), bool)
    mask[5:, 100:] = False
    ref = np.asarray(J.predict_3di_codes(params, cfg, jnp.asarray(tokens), jnp.asarray(mask)))
    jm = jmesh.make_mesh()
    with jm:
        jsh = np.asarray(jsharding.make_sharded_predict(cfg, jm)(
            jsharding.shard_params(params, jm), jnp.asarray(tokens), jnp.asarray(mask)))
    assert np.array_equal(jsh, ref)

    tcfg = T.T5Config(d_model=128, d_kv=16, n_heads=8, d_ff=256, n_layers=2)
    model = T.build_model(tcfg, prostt5_from_jax(params), "cpu")
    run = sharding.make_sharded_predict(tcfg, model, mesh_mod.make_mesh(devices=["cpu"] * 4, dp=4, tp=1))
    got = run(tokens, mask)
    assert got.shape == ref.shape
    logits = np.asarray(J.residue_logits(params, cfg, jnp.asarray(tokens), jnp.asarray(mask)))
    rows = [TDI[r].tobytes().decode() for r in ref]
    assert_same_3di(rows, rows, [TDI[g].tobytes().decode() for g in got], lambda i: logits[i], "float32")


def test_sharded_predict_tensor_parallel_matches_jax():
    """tp = 2 (the refusal of tensor parallelism is gone): the port's
    sharded predict over a (2, 2) mesh of CPU shards against JAX's on
    its (2, 2) mesh, float32, ragged masks, under the tie rule."""
    cfg = J.T5Config(d_model=64, d_kv=16, n_heads=4, d_ff=128, n_layers=1, cnn_hidden=8)
    params = J.init_params(cfg, seed=1, dtype=jnp.float32)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 24, (8, 64)).astype(np.int32)
    mask = np.ones((8, 64), bool)
    mask[3:, 40:] = False
    jm = jmesh.make_mesh(n_devices=4, dp=2, tp=2)
    with jm:
        ref = np.asarray(jsharding.make_sharded_predict(cfg, jm)(
            jsharding.shard_params(params, jm), jnp.asarray(tokens), jnp.asarray(mask)))
    tcfg = T.T5Config(d_model=64, d_kv=16, n_heads=4, d_ff=128, n_layers=1, cnn_hidden=8)
    model = T.build_model(tcfg, prostt5_from_jax(params), "cpu")
    got = sharding.make_sharded_predict(tcfg, model, mesh_mod.make_mesh(devices=["cpu"] * 4, dp=2, tp=2))(
        tokens, mask)
    assert got.shape == ref.shape
    logits = np.asarray(J.residue_logits(params, cfg, jnp.asarray(tokens), jnp.asarray(mask)))
    rows = [TDI[r].tobytes().decode() for r in ref]
    assert_same_3di(rows, rows, [TDI[g].tobytes().decode() for g in got], lambda i: logits[i], "float32")


def test_engine_predict_sharded_matches_jax(port_env, monkeypatch):  # noqa: F811
    """ProstT5Engine.predict with local_mesh patched to 4 CPU shards (each
    batch padded to 32 rows) against JAX's engine (sharded over its 8
    virtual devices), float32, mixed lengths in two buckets."""
    write_prostt5_checkpoint(port_env / "ckpt", "bin", seed=4)
    monkeypatch.setattr(mesh_mod, "local_mesh", lambda device=None: mesh_mod.make_mesh(
        devices=["cpu"] * 4, dp=4, tp=1))
    made = []
    real = sharding.make_sharded_predict
    monkeypatch.setattr(sharding, "make_sharded_predict", lambda *a: made.append(a[2]) or real(*a))
    je = J.ProstT5Engine(str(port_env / "ckpt"), dtype=jnp.float32)
    te = T.ProstT5Engine(str(port_env / "ckpt"), dtype=torch.float32, device="cpu")
    seqs = _seqs(np.random.RandomState(8), [42, 20, 2, 130, 7, 90]) + ["MKVXLBZJWW"]
    from unicore_tpu_torch.runtime import profiling
    profiling.reset_counters()
    got = te.predict(seqs)
    assert len(made) == 1 and made[0].devices.size == 4
    assert profiling.get_counters()["prostt5.padded_tokens"] == 32 * 128 + 32 * 256
    assert_same_3di(seqs, je.predict(seqs), got, lambda i: _jax_unit_logits(je)(seqs[i]), "float32")
    assert len(jax.devices()) == 8
