"""ProstT5's training step and its tensor and sequence parallelism
(parallel/sharding.py, graft_entry.py) against the JAX package's
(unicore_tpu/parallel/sharding.py, __graft_entry__.py), on the CPU: JAX
float32 on its 8 virtual devices, the port on meshes of CPU shards.

Tolerances, float32 (the port and JAX sum the same products in other
orders, and a sharded model sums the tp shards' shares apart):

  * loss within LOSS_RTOL relative;
  * each gradient tensor within GRAD_RTOL max|g_ref| of the reference;
  * parameters after Adam steps, as updates u = p_after - p_before: Adam's
    first step is about lr sign(g), so an entry whose gradient is float
    noise may flip sign.  Entries with |g_ref| >= STRONG max|g_ref| (of
    their tensor, g_ref the first step's reference gradient) hold u
    within UPDATE_RTOL |u_ref|, plus per step one float32 spacing of the
    parameter and lr GRAD_NOISE max|g_ref| / |g_ref|; every entry within
    2 lr steps.  The two terms matter where the steps' updates cancel
    (the gradient turns): each step rounds p - update to float32, and
    moves Adam's m̂ / √v̂ by about δ / |g| for a gradient error δ, here
    float32 summation noise of a few 1e-7 max|g| (measured: at most
    2.9e-7 over this file's Adam steps at lr 1e-3 and 1e-4).

The same tolerances hold a sharded model against the unsharded port, at
this file's depth (2 layers, a few steps).  Deeper they do not, in either
package: where an FFN relu's input is within float noise of 0, two
float32 sums take different derivatives, and Adam's first step turns
gradient noise into lr-sized moves that a deep stack amplifies (at 24
layers JAX's own tp = 4 step parts from its unsharded one by 2e-5 after
one step); chip_smoke.py phase 10 holds its full-width runs accordingly.
The `cuda`-marked test needs no JAX and runs on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train.py -m cuda -q

JAX is imported inside the tests that use it for that reason."""

import numpy as np
import pytest
import torch

from torch_port_helpers import TIE_RTOL, assert_same_3di, need_cuda
from unicore_tpu_torch import graft_entry
from unicore_tpu_torch.alphabets import TDI_ALPHABET
from unicore_tpu_torch.convert import prostt5_from_jax, prostt5_to_jax
from unicore_tpu_torch.models import prostt5 as T
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.parallel import sharding

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3
STRONG = 1e-3
GRAD_NOISE = 1e-6
LR = 1e-3
DIMS = dict(d_model=64, d_kv=8, n_heads=8, d_ff=128, n_layers=2, cnn_hidden=16)
TDI = np.frombuffer(TDI_ALPHABET.encode(), np.uint8)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at the top: the
    `cuda` test runs where JAX is absent)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from unicore_tpu.models import prostt5
    from unicore_tpu.parallel import mesh, sharding as jsharding

    assert len(jax.devices()) == 8, "tests/conftest.py must provide 8 virtual devices"
    return dict(jax=jax, jnp=jnp, P=prostt5, mesh=mesh, sh=jsharding, NS=NamedSharding, PS=PartitionSpec)


def _batch(seed, B, L):
    """Framed rows of ragged lengths (one full, one of 3 residues, the
    rest random), their mask, and random labels."""
    rng = np.random.RandomState(seed)
    lengths = np.concatenate([[L - 2, 3], rng.randint(1, L - 1, B - 2)])
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYX"), n)) for n in lengths]
    tokens, mask = T.frame_batch(seqs, L, multiple=1)
    return tokens.astype(np.int32), mask, rng.randint(0, 20, (B, L)).astype(np.int32)


def _init(J, ff, seed=0):
    """(JAX cfg, port cfg, JAX float32 params) of DIMS with a nonzero
    first conv bias (so relu(b1) would show at the sequence ends)."""
    jcfg = J["P"].T5Config(**DIMS, ff=ff)
    params = J["P"].init_params(jcfg, seed=seed, dtype=J["jnp"].float32)
    params["cnn"]["b1"] = J["jnp"].asarray(np.random.RandomState(seed + 1).randn(DIMS["cnn_hidden"]), J["jnp"].float32)
    return jcfg, T.T5Config(**DIMS, ff=ff), params


def _jax_loss_grads(J, jcfg, params, batch):
    """JAX's loss and gradients (a tree) on one device."""
    jnp = J["jnp"]
    with J["mesh"].make_mesh(n_devices=1, dp=1, tp=1):
        loss, grads = J["jax"].value_and_grad(J["sh"].loss_fn)(params, jcfg, *(jnp.asarray(x) for x in batch))
    return float(loss), J["jax"].tree_util.tree_map(np.asarray, grads)


def _jax_steps(J, jcfg, params, batch, steps, dp=1, tp=1):
    """JAX's make_train_step on a (dp, tp) mesh of its virtual devices:
    (losses, final params as numpy)."""
    jax, jnp = J["jax"], J["jnp"]
    mesh = J["mesh"].make_mesh(n_devices=dp * tp, dp=dp, tp=tp)
    losses = []
    with mesh:
        p = J["sh"].shard_params(params, mesh)
        step, init_opt = J["sh"].make_train_step(jcfg, mesh, lr=LR)
        opt = init_opt(p)
        ds = J["NS"](mesh, J["PS"]("dp", None))
        args = [jax.device_put(jnp.asarray(x), ds) for x in batch]
        for _ in range(steps):
            p, opt, loss = step(p, opt, *args)
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


def _port_steps(model, cfg, batch, steps, mesh=None):
    """The port's make_train_step: (losses, the first step's gradients as
    a state)."""
    step, init_opt = sharding.make_train_step(cfg, mesh, lr=LR)
    opt = init_opt(model)
    losses, grads = [], None
    for _ in range(steps):
        losses.append(step(model, opt, *batch))
        if grads is None:
            grads = _grads(model)
    return losses, grads


def _grads(model):
    if isinstance(model, sharding.ShardedProstT5):
        return sharding.gather_state(model, grad=True)
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _leaves(tree):
    """{path: array} of a JAX-layout tree."""
    out = {k: tree[k] for k in ("embed", "rel_bias", "final_ln")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out.update({f"cnn.{k}": v for k, v in tree["cnn"].items()})
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def assert_grads_close(ref_tree, got_tree):
    ref, got = _leaves(ref_tree), _leaves(got_tree)
    assert ref.keys() == got.keys()
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert scale > 0, k
        err = np.abs(got[k] - ref[k]).max() / scale
        assert err <= GRAD_RTOL, (k, err)


def assert_updates_close(p0_tree, ref_tree, got_tree, g_ref_tree, steps):
    """The Adam rule of the module docstring."""
    p0, ref, got, g = (_leaves(t) for t in (p0_tree, ref_tree, got_tree, g_ref_tree))
    for k in p0:
        u_ref, u_got = ref[k] - p0[k], got[k] - p0[k]
        d = np.abs(u_got - u_ref)
        assert d.max() <= 2 * LR * steps, (k, d.max())
        strong = np.abs(g[k]) >= STRONG * np.abs(g[k]).max()
        assert strong.any(), k
        spacing = np.spacing(np.maximum(np.abs(p0[k]), np.abs(ref[k])).astype(np.float32))
        turn = LR * GRAD_NOISE * np.abs(g[k]).max() / np.maximum(np.abs(g[k]), 1e-30)
        tol = UPDATE_RTOL * np.abs(u_ref) + steps * (spacing + turn)
        assert np.all(d[strong] <= tol[strong]), (k, (d / tol)[strong].max())


def assert_losses_close(ref, got):
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_loss_and_gradients_match_jax(J, ff):
    jcfg, cfg, params = _init(J, ff)
    batch = _batch(1, 4, 32)
    loss_ref, g_ref = _jax_loss_grads(J, jcfg, params, batch)
    model = T.build_model(cfg, prostt5_from_jax(params), "cpu", trainable=True)
    loss = sharding.loss_fn(model, cfg, *batch)
    loss.backward()
    assert_losses_close([loss_ref], [loss.item()])
    assert_grads_close(g_ref, prostt5_to_jax({k: p.grad for k, p in model.named_parameters()}))


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_adam_steps_match_jax(J, ff):
    """Three steps on one batch against JAX's make_train_step (optax.adam)."""
    jcfg, cfg, params = _init(J, ff)
    batch = _batch(2, 4, 32)
    _, g_ref = _jax_loss_grads(J, jcfg, params, batch)
    losses_ref, p_ref = _jax_steps(J, jcfg, params, batch, 3)
    model = T.build_model(cfg, prostt5_from_jax(params), "cpu", trainable=True)
    losses, _ = _port_steps(model, cfg, batch, 3)
    assert_losses_close(losses_ref, losses)
    assert losses[-1] < losses[0]
    assert_updates_close(params, p_ref, prostt5_to_jax(model), g_ref, 3)


def test_train_step_refuses_another_mesh():
    cfg = T.T5Config(**DIMS)
    model = T.build_model(cfg, T.init_params(cfg, 0, torch.float32), "cpu", trainable=True)
    step, init_opt = sharding.make_train_step(cfg, mesh_mod.make_mesh(devices=["cpu"] * 2, dp=2, tp=1))
    with pytest.raises(ValueError, match="mesh"):
        step(model, init_opt(model), *_batch(0, 2, 16))


# ---------------------------------------------------------------------------
# sharded
# ---------------------------------------------------------------------------

def test_param_pspecs_mirror_jax(J):
    """The port's spec of each tensor is JAX's on the transposed (HF)
    layout; gather_state reads shard_params' slices back exactly."""
    for ff in ("relu", "gated-gelu"):
        jcfg, cfg, params = _init(J, ff)
        jspec = J["sh"].param_pspecs(params)
        state = prostt5_from_jax(params)
        specs = sharding.param_pspecs(state)
        for i, layer in enumerate(jspec["layers"]):
            for name, spec in layer.items():
                want = tuple(reversed(tuple(spec))) if len(spec) == 2 else ()
                assert specs[f"encoder.blocks.{i}.{name}.weight"] == want, (name, spec)
        assert all(not specs[k] for k in state if not k.startswith("encoder.blocks."))
        assert all(not specs[f"encoder.blocks.0.{n}.weight"] for n in ("ln1", "ln2"))
        sharded = sharding.shard_params(state, mesh_mod.make_mesh(devices=["cpu"] * 8, dp=2, tp=4))
        assert len(sharded.slices) == 4 and sharded.slices[0]["encoder/blocks/0/q/weight"].shape == (16, 64)
        back = sharding.gather_state(sharded)
        assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
        assert all(g is None for g in sharding.gather_state(sharded, grad=True).values())


def test_shard_params_and_the_sharded_forward_refuse_bad_shapes():
    cfg = T.T5Config(**dict(DIMS, n_heads=6, d_kv=8))
    state = T.init_params(cfg, 0, torch.float32)
    with pytest.raises(ValueError, match="must divide n_heads"):
        sharding.shard_params(state, mesh_mod.make_mesh(devices=["cpu"] * 4, dp=1, tp=4))
    cfg = T.T5Config(**DIMS)
    model = sharding.shard_params(T.init_params(cfg, 0, torch.float32),
                                  mesh_mod.make_mesh(devices=["cpu"] * 4, dp=2, tp=2))
    with pytest.raises(ValueError, match="pad it first"):  # B = 3 over dp = 2
        sharding.loss_fn(model, cfg, *_batch(0, 3, 16))
    with pytest.raises(ValueError, match="not a multiple of tp"):  # L = 15 over tp = 2
        sharding.loss_fn(model, cfg, *_batch(0, 4, 15))


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2), (1, 8)])
def test_sharded_step_matches_jax_and_the_unsharded_port(J, dp, tp):
    """Two steps on ragged rows: the port's sharded step against JAX's
    sharded step and against the port on one device (loss, the first
    step's gradients, the updates)."""
    jcfg, cfg, params = _init(J, "relu" if tp != 2 else "gated-gelu", seed=dp * 10 + tp)
    batch = _batch(dp + tp, 4 * dp, 32)
    _, g_ref = _jax_loss_grads(J, jcfg, params, batch)
    losses_ref, p_ref = _jax_steps(J, jcfg, params, batch, 2, dp, tp)
    mesh = mesh_mod.make_mesh(devices=["cpu"] * (dp * tp), dp=dp, tp=tp)
    sharded = sharding.shard_params(prostt5_from_jax(params), mesh)
    losses, grads = _port_steps(sharded, cfg, batch, 2, mesh)
    single = T.build_model(cfg, prostt5_from_jax(params), "cpu", trainable=True)
    losses_1, grads_1 = _port_steps(single, cfg, batch, 2)
    assert_losses_close(losses_ref, losses)
    assert_losses_close(losses_1, losses)
    assert_grads_close(g_ref, prostt5_to_jax(grads))
    assert_grads_close(prostt5_to_jax(grads_1), prostt5_to_jax(grads))
    assert_updates_close(params, p_ref, prostt5_to_jax(sharded), g_ref, 2)
    assert_updates_close(params, prostt5_to_jax(single), prostt5_to_jax(sharded), g_ref, 2)


def _head_cases(L):
    """(name, res_mask) cases for the sp head at length L = 32: none (the
    training head), residues ending at a shard border of tp 2 and 4 (16)
    and next to it (15, 17), one residue, a prefix and a padded tail."""
    cases = [("no mask", None)]
    for end in (16, 15, 17, 2, L - 1):
        m = np.zeros((2, L), bool)
        m[0, 1:end] = True
        m[1, :L] = True
        cases.append((f"residues 1..{end}", torch.as_tensor(m)))
    return cases


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sequence_parallel_head_equals_whole_sequence_head(tp):
    """Shard borders next to the sequence's ends and next to masked
    padding; at tp 8 a shard (4 rows) is narrower than its halo (6)."""
    cfg = T.T5Config(**DIMS)
    state = T.init_params(cfg, 3, torch.float32)
    gen = torch.Generator().manual_seed(tp)
    state["head.conv1.bias"] = torch.randn(DIMS["cnn_hidden"], generator=gen)
    state["head.conv2.bias"] = torch.randn(20, generator=gen)
    model = T.build_model(cfg, state, "cpu")
    sharded = sharding.shard_params(state, mesh_mod.make_mesh(devices=["cpu"] * tp, dp=1, tp=tp))
    h = torch.randn(2, 32, DIMS["d_model"], generator=gen)
    for name, res in _head_cases(32):
        ref = T.cnn_head(model, h, res)
        with torch.no_grad():
            blocks = sharded.head(h, 0, res)
        assert len(blocks) == tp and all(b.shape == (2, 32 // tp, 20) for b in blocks)
        got = torch.cat(blocks, dim=1)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()), msg=name)


@pytest.mark.parametrize("dtype,dp,tp", [("float32", 2, 4), ("bfloat16", 1, 8), ("bfloat16", 2, 2)])
def test_tensor_parallel_predict_matches_jax(J, dtype, dp, tp):
    """make_sharded_predict with tp > 1 against JAX's
    make_sharded_predict(shard_params(...)) on its (dp, tp) mesh, under
    the tie rule with JAX's logits."""
    jnp = J["jnp"]
    jcfg, cfg, _ = _init(J, "relu")
    params = J["P"].init_params(jcfg, seed=5, dtype=getattr(jnp, dtype))
    tokens, mask, _ = _batch(7, 4 * dp, 64)
    jmesh = J["mesh"].make_mesh(n_devices=dp * tp, dp=dp, tp=tp)
    with jmesh:
        ref = np.asarray(J["sh"].make_sharded_predict(jcfg, jmesh)(
            J["sh"].shard_params(params, jmesh), jnp.asarray(tokens), jnp.asarray(mask)))
    logits = np.asarray(J["P"].residue_logits(params, jcfg, jnp.asarray(tokens), jnp.asarray(mask)), np.float32)
    model = T.build_model(cfg, prostt5_from_jax(params), "cpu")
    assert next(model.parameters()).dtype == getattr(torch, dtype)
    got = sharding.make_sharded_predict(cfg, model, mesh_mod.make_mesh(devices=["cpu"] * (dp * tp), dp=dp, tp=tp))(
        tokens, mask)
    assert got.shape == ref.shape
    rows = [TDI[r].tobytes().decode() for r in ref]
    assert_same_3di(rows, rows, [TDI[g].tobytes().decode() for g in got], lambda i: logits[i], dtype)


# ---------------------------------------------------------------------------
# the port's graft entry points
# ---------------------------------------------------------------------------

def test_entry_matches_jax(J):
    """entry() on the CPU: the (8, 256) bf16 3Di codes of JAX's entry()
    under the tie rule."""
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    ref = np.asarray(J["jax"].jit(jfn)(*jargs))
    logits = np.asarray(J["P"].residue_logits(jargs[0], J["P"].T5Config.small(), *jargs[1:]), np.float32)
    fn, args = graft_entry.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == ref.shape == (8, 256)
    rows = [TDI[r].tobytes().decode() for r in ref]
    assert_same_3di(rows, rows, [TDI[g].tobytes().decode() for g in got], lambda i: logits[i], "bfloat16")


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_shards(J, n, capsys):
    """graft_entry.dryrun_multichip(n) over n CPU shards: its six checks
    pass, and its loss is JAX's loss_fn at the dry run's configuration."""
    out = graft_entry.dryrun_multichip(n, devices=["cpu"] * n)
    assert capsys.readouterr().out.count("dryrun_multichip ok") == 6
    assert (out["dp"], out["tp"]) == {4: (1, 4), 8: (1, 8)}[n]
    jnp = J["jnp"]
    jcfg = J["P"].T5Config(d_model=128, d_kv=16, n_heads=8, d_ff=256, n_layers=2)
    rng = np.random.RandomState(0)
    B = out["dp"] * 8
    tokens = rng.randint(0, 20, (B, 128)).astype(np.int32)
    labels = rng.randint(0, 20, (B, 128)).astype(np.int32)
    with J["mesh"].make_mesh(n_devices=1, dp=1, tp=1):
        ref = float(J["sh"].loss_fn(J["P"].init_params(jcfg, seed=0, dtype=jnp.float32), jcfg,
                                    jnp.asarray(tokens), jnp.ones((B, 128), bool), jnp.asarray(labels)))
    assert_losses_close([ref], [out["loss"]])


def test_same_codes_refuses_a_difference_off_a_tie():
    logits = np.array([[[0.0, 1.0, 0.999999], [0.0, 1.0, 0.5]]], np.float32)
    ref = logits.argmax(-1)
    assert graft_entry.same_codes(ref, np.array([[2, 1]]), logits, "tie") == 1
    with pytest.raises(AssertionError, match="not all on ties"):
        graft_entry.same_codes(ref, np.array([[1, 2]]), logits, "off a tie")
    assert TIE_RTOL["float32"] == graft_entry.TIE_RTOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_step_on_the_card_matches_the_cpu():
    """(dp, tp) = (2, 2) on a logical mesh of the card against the port on
    one CPU device: losses, the first step's gradients and the updates of
    two steps, with this file's tolerances."""
    need_cuda()
    cfg = T.T5Config(**DIMS)
    state = T.init_params(cfg, 4, torch.float32)
    batch = _batch(4, 8, 32)
    mesh = mesh_mod.make_mesh(devices=["cuda"] * 4, dp=2, tp=2)
    sharded = sharding.shard_params(state, mesh)
    assert sharded.slices[1]["encoder/blocks/0/wo/weight"].is_cuda
    losses, grads = _port_steps(sharded, cfg, batch, 2, mesh)
    single = T.build_model(cfg, {k: v.clone() for k, v in state.items()}, "cpu", trainable=True)
    losses_1, grads_1 = _port_steps(single, cfg, batch, 2)
    assert_losses_close(losses_1, losses)
    g_ref = prostt5_to_jax(grads_1)
    assert_grads_close(g_ref, prostt5_to_jax(grads))
    assert_updates_close(prostt5_to_jax(state), prostt5_to_jax(single), prostt5_to_jax(sharded), g_ref, 2)
