"""The port's data-parallel functions and the engines' multi-device
branches, on meshes of CPU shards, against the JAX package's sharded
functions on the 8 virtual XLA devices of tests/conftest.py.

SW, banded SW and NW give results per pair: sharded results must be
bit-identical to JAX's sharded ones and to the port's single-device
call.  The likelihood and the gene batches are float32 over batches of
another shape: within rtol 2e-5 and atol 1e-3, the tolerance of
tests/test_sharded_backhalf.py.  The JAX engines never take their
multi-device branches on the CPU, so the port's branches (local_mesh
monkeypatched to 4 CPU shards) are held against JAX's single-device
outputs: `cluster`'s clust.tsv byte-identical, `nw_align_batch`'s paths
equal."""

import jax
import numpy as np
import pytest
import torch

from test_torch_banded import _band_batch
from torch_port_helpers import as_torch, files_of, port_env, random_pairs, write_proteomes  # noqa: F401
from unicore_tpu.cli import main as jax_main
from unicore_tpu.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu.ops import banded as jb
from unicore_tpu.ops import nw_device as jnw
from unicore_tpu.ops import sw as jsw
from unicore_tpu.phylo import genebatch as jgb
from unicore_tpu.phylo import likelihood as jl
from unicore_tpu.phylo import models as jm
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.ops import banded as tb
from unicore_tpu_torch.ops import nw as tnw
from unicore_tpu_torch.ops import nw_device as tnwd
from unicore_tpu_torch.ops import sw_cuda
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.phylo import genebatch as tgb
from unicore_tpu_torch.phylo import likelihood as tl
from unicore_tpu_torch.phylo import models as tm
from unicore_tpu_torch.phylo.newick import Node
from unicore_tpu_torch.synthetic import nw_scores

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
LL_RTOL, LL_ATOL = 2e-5, 1e-3  # tests/test_sharded_backhalf.py


def _jmesh():
    assert len(jax.devices()) == 8, "tests/conftest.py must provide 8 virtual devices"
    return jax.sharding.Mesh(np.asarray(jax.devices()), ("dp",))


def _tmesh(n=8):
    return mesh_mod.make_mesh(devices=["cpu"] * n, dp=n, tp=1)


@pytest.fixture
def cpu_local_mesh(monkeypatch):
    """local_mesh patched to 4 CPU shards: every engine branch shards."""
    mesh = _tmesh(4)
    monkeypatch.setattr(mesh_mod, "local_mesh", lambda device=None: mesh)
    return mesh


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


# ---------------------------------------------------------------------------
# the sharded functions against JAX's on 8 devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,bias,B0", [
    ("gapped_w0", False, 32), ("gapped_w64", True, 32), ("ungapped", False, 32),
    ("ungapped", True, 32), ("gapped_w64", True, 27)])
def test_sw_forward_sharded_matches_jax(mode, bias, B0):
    """B0 = 27 is padded as the engine pads (code 20, length 1, zero bias)."""
    rng = np.random.RandomState(len(mode) * 100 + B0 + bias)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, B0, 64, 80)
    qc = rng.randint(-60, 40, (B0, 64)).astype(np.int32) if bias else None
    kw = dict(ungapped=mode == "ungapped", gap_window=64 if mode == "gapped_w64" else 0)
    B = mesh_mod.round_up(B0, 8)
    pad = mesh_mod.pad_rows
    padded = [pad(qa, B, 20), pad(qs, B, 20), pad(ta, B, 20), pad(ts, B, 20), pad(ql, B, 1), pad(tl, B, 1)]
    qcp = None if qc is None else pad(qc, B, 0)
    ref = jsw.sw_forward_sharded(*padded, SAA, S3D, _jmesh(), backend="xla", qc=qcp, **kw)
    got = sw_cuda.sw_forward_sharded(*padded, SAA, S3D, _tmesh(), qc=qcp, **kw)
    single = sw_cuda.sw_forward_cuda(*as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D), qc=as_torch(qc)[0], **kw)
    for name, r, g, s in zip(("best", "qend", "tend"), ref, got, single):
        r = np.asarray(r)
        assert g.dtype == s.dtype and g.shape == (B,), name
        assert np.array_equal(r, g.numpy()), name
        assert np.array_equal(g.numpy()[:B0], s.numpy()), name
    assert float(got[0].max()) > 0
    assert sw_cuda.SHARDED_LAUNCHES == {"gapped": 0, "ungapped": 0}  # CPU shards launch nothing


def test_sw_forward_sharded_needs_a_multiple_of_the_shards():
    qa, qs, ta, ts, ql, tl = random_pairs(np.random.RandomState(0), 6, 16, 16)
    with pytest.raises(ValueError, match="pad it first"):
        sw_cuda.sw_forward_sharded(qa, qs, ta, ts, ql, tl, SAA, S3D, _tmesh(4))


@pytest.mark.parametrize("mode,bias", [("w64", True), ("w0", False), ("ungapped", True)])
def test_sw_forward_banded_sharded_matches_jax(mode, bias):
    qa, qs, ta, ts, ql, tl, d0, qc = _band_batch(5, 8, 256, 256, bias)
    kw = dict(W=128, go=100.0, ge=10.0, w_aa=4.0, w_3di=6.0,
              gap_window=64 if mode == "w64" else 0, ungapped=mode == "ungapped")
    ref = jb.sw_forward_banded_sharded(qa, qs, ta, ts, ql, tl, d0, SAA, S3D, _jmesh(), qc=qc, **kw)
    got = tb.sw_forward_banded_sharded(qa, qs, ta, ts, ql, tl, d0, SAA, S3D, _tmesh(), qc=qc, **kw)
    t = as_torch(qa, qs, ta, ts, ql, tl, d0, SAA, S3D, qc)
    single = tb.sw_forward_banded(*t[:9], qc=t[9], **kw)
    for r, g, s in zip(ref, got, single):
        assert np.array_equal(np.asarray(r), g.numpy())
        assert torch.equal(g, s)
    assert float(got[0].max()) > 0


@pytest.mark.parametrize("kind", ["rand", "zero"])
def test_nw_forward_bits_sharded_matches_jax(kind):
    rng = np.random.RandomState(5)
    S, l1, l2 = nw_scores(rng, 16, 64, 48, kind)
    ref = jnw.nw_forward_bits_sharded(S, l1, l2, 2816, 256, _jmesh())
    got = tnwd.nw_forward_bits_sharded(S, l1, l2, 2816, 256, _tmesh())
    single = tnwd.nw_forward_bits(*as_torch(S, l1, l2), 2816, 256)
    for name, r, g, s in zip(("bits", "end_i", "end_j", "score"), ref, got, single):
        assert np.array_equal(np.asarray(r), g.numpy()), name
        assert torch.equal(g, s), name


# ---------------------------------------------------------------------------
# the likelihood and the gene batches (test_sharded_backhalf.py's geometry)
# ---------------------------------------------------------------------------

def _alignment(seed, n=6, L=60):
    rng = np.random.RandomState(seed)
    AA = "ARNDCQEGHILKMFPSTWYV"
    base = rng.choice(list(AA), L)
    seqs = []
    for _ in range(n):
        s = base.copy()
        pos = rng.choice(L, L // 4, replace=False)
        s[pos] = rng.choice(list(AA), len(pos))
        seqs.append("".join(s))
    return [f"t{i}" for i in range(n)], seqs


def _engines(seed, pad_to=0):
    names, seqs = _alignment(seed)
    je = jl.LikelihoodEngine(names, seqs, jm.SubstModel.build(jm.ModelSpec.parse("JTT+G")),
                             pad_patterns_to=pad_to)
    te = tl.LikelihoodEngine(names, seqs, tm.SubstModel.build(tm.ModelSpec.parse("JTT+G")),
                             device="cpu", pad_patterns_to=pad_to)
    return je, te


def _random_topologies(names, k, seed):
    rng = np.random.RandomState(seed)
    cbs, bbs = [], []
    for _ in range(k):
        order = list(names)
        rng.shuffle(order)
        nodes = [Node(name=nm) for nm in order]
        while len(nodes) > 1:
            a = nodes.pop(rng.randint(len(nodes)))
            b = nodes.pop(rng.randint(len(nodes)))
            p = Node()
            p.add(a)
            p.add(b)
            a.length = float(rng.uniform(0.05, 0.4))
            b.length = float(rng.uniform(0.05, 0.4))
            nodes.append(p)
        c, b = tl.tree_to_arrays(tl.make_root_binary(nodes[0]), list(names))
        cbs.append(c)
        bbs.append(b)
    return np.stack(cbs), np.stack(bbs)


@pytest.mark.parametrize("site,k", [(False, 10), (True, 9)])
def test_loglik_batch_sharded_matches_jax(site, k, cpu_local_mesh):
    """k = 9 and 10 pad to 16 over 8 shards; mesh=None takes local_mesh
    (patched here) and mesh=False one device."""
    je, te = _engines(seed=int(site))
    cb, bb = _random_topologies(je.names, k, seed=3 + site)
    fn = "site_loglik_batch" if site else "loglik_batch"
    ref = getattr(je, fn)(cb, bb, mesh=_jmesh())
    got = getattr(te, fn)(cb, bb, mesh=_tmesh())
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=LL_RTOL, atol=LL_ATOL)
    single = getattr(te, fn)(cb, bb, mesh=False)
    np.testing.assert_allclose(got, single, rtol=LL_RTOL, atol=LL_ATOL)
    np.testing.assert_allclose(getattr(te, fn)(cb, bb), single, rtol=LL_RTOL, atol=LL_ATOL)
    # one replica of the tips and the model per device, made once
    assert set(te._replicas) == {(torch.device("cpu"), 0)}


def test_loglik_multi_sharded_matches_jax(cpu_local_mesh):
    """Three genes pad to 8 over 8 shards (JAX's test); loglik_multi with
    local_mesh patched takes the sharded call."""
    jengs, tengs = zip(*(_engines(seed=s, pad_to=64) for s in range(3)))
    cbs, bbs = zip(*(_random_topologies(e.names, 4, seed=7) for e in jengs))
    cgk, bgk = np.stack(cbs), np.stack(bbs).astype(np.float32)
    keys = ("eigvals", "U", "Uinv", "pi", "rates", "props")
    jmodel = {k + "_g": np.stack([np.asarray(e._mp[k]) for e in jengs]) for k in keys}
    ref = jgb._loglik_multi_sharded(_jmesh(), cgk, bgk, np.stack([np.asarray(e.tips) for e in jengs]),
                                    np.stack([np.asarray(e.w) for e in jengs]), 6, jmodel)
    tmodel = {k + "_g": torch.stack([e._mp[k] for e in tengs]) for k in keys}
    got = tgb._loglik_multi_sharded(_tmesh(), cgk, bgk, torch.stack([e.tips for e in tengs]),
                                    torch.stack([e.w for e in tengs]), tmodel)
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(got, ref, rtol=LL_RTOL, atol=LL_ATOL)
    np.testing.assert_allclose(tgb.loglik_multi(list(tengs), cgk, bgk), got, rtol=LL_RTOL, atol=LL_ATOL)


# ---------------------------------------------------------------------------
# the engine branches, local_mesh patched to 4 CPU shards
# ---------------------------------------------------------------------------

def test_cluster_sharded_matches_jax(port_env, cpu_local_mesh, monkeypatch):  # noqa: F811
    """createdb mock -> cluster through both CLIs (the calibration, the
    rescore, both SW passes and the banded pass of the 1,100-residue
    family all through the sharded branches): clust.tsv byte-identical."""
    calls = _spy(monkeypatch, sw_cuda, "sw_forward_sharded")
    banded = _spy(monkeypatch, tb, "sw_forward_banded_sharded")
    ind = port_env / "in"
    write_proteomes(ind)
    outs = []
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        db = str(port_env / side / "proteome" / "proteome_db")
        assert main(["createdb", str(ind), db, "mock", "-v", "1"]) == 0
        assert main(["cluster", db, str(port_env / side / "cluster" / "clust"),
                     str(port_env / side / "tmp"), "-v", "1"]) == 0
        outs.append(files_of(port_env / side / "cluster"))
    assert outs[0]["clust.tsv"] == outs[1]["clust.tsv"]
    assert outs[1]["clust.tsv"].count(b"\n") > 20
    assert calls and banded


@pytest.mark.parametrize("gaps", [(2816, 256), (1100, 100)])
def test_nw_align_batch_sharded_matches_jax(gaps, cpu_local_mesh, monkeypatch):
    """Ragged batches in four buckets (batches of 1 to 5 pad to 4 or 8
    rows), the degenerate shapes and a tie-heavy matrix."""
    calls = _spy(monkeypatch, tnwd, "nw_forward_bits_sharded")
    rng = np.random.RandomState(42)
    S_list = []
    for a, b in [(12, 17), (1, 9), (9, 1), (64, 64), (33, 70), (128, 40), (200, 3), (5, 300)]:
        S = rng.randn(a, b) * 2.0 - 1.0
        S[np.arange(min(a, b)), np.arange(min(a, b))] += 6.0
        S_list.append(tnw.quantize_scores(S))
    S_list += [tnw.quantize_scores(np.full((5, 5), -3.0)), np.zeros((7, 9), np.int32),
               np.zeros((0, 4), np.int32), np.zeros((6, 0), np.int32)]
    go, ge = gaps
    ref = jnw.nw_align_batch(S_list, go, ge)
    got = tnwd.nw_align_batch(S_list, go, ge, device="cpu")
    assert got == ref
    assert len(calls) == 4  # one per bucket


def test_pad_rows():
    x = np.arange(6, dtype=np.int32).reshape(3, 2)
    assert np.array_equal(mesh_mod.pad_rows(x, 5, 20), [[0, 1], [2, 3], [4, 5], [20, 20], [20, 20]])
    assert np.array_equal(mesh_mod.pad_rows(x, 4), [[0, 1], [2, 3], [4, 5], [0, 1]])
    assert mesh_mod.pad_rows(x, 3) is x
    t = torch.from_numpy(x)
    assert torch.equal(mesh_mod.pad_rows(t, 4), torch.from_numpy(mesh_mod.pad_rows(x, 4)))
    assert torch.equal(mesh_mod.pad_rows(t, 5, 20), torch.from_numpy(mesh_mod.pad_rows(x, 5, 20)))
    assert mesh_mod.round_up(27, 8) == 32 and mesh_mod.round_up(32, 8) == 32


def test_shard_and_gather_keep_the_order():
    x = np.arange(24).reshape(12, 2)
    parts = mesh_mod.shard(x, mesh_mod.shard_devices(_tmesh(4)), torch.int32)
    assert [p.shape for p in parts] == [(3, 2)] * 4 and parts[0].dtype == torch.int32
    assert np.array_equal(mesh_mod.gather(parts).numpy(), x)
    with pytest.raises(ValueError):
        mesh_mod.shard(x[:10], mesh_mod.shard_devices(_tmesh(4)))
    # a (dp, tp) mesh shards over dp: the first device of each tp group
    m = mesh_mod.make_mesh(devices=["cpu"] * 8, dp=2, tp=4)
    assert mesh_mod.n_shards(m) == 2 and len(mesh_mod.shard_devices(m)) == 2
    r = mesh_mod.Replicas(torch.ones(3))
    assert r.on(torch.device("cpu")) is r.on(torch.device("cpu"))
