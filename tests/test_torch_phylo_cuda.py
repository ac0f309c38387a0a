"""The likelihood engine and one tree inference on the card against the same
calls on the CPU, with TF32 matmuls allowed process-wide
(`torch.set_float32_matmul_precision("high")`): the engine's products must
still run at full float32 (phylo/likelihood.py::full_fp32).

Tolerances: those of tests/test_torch_phylo.py (port against JAX), since
the card and the CPU round float32 products differently in the same way
two backends do: lnL |d| <= LL_RTOL |lnL|; sites |d| <= SITE_ATOL +
SITE_RTOL |s|; after 150 Adam steps lnL within BLEN_LL_RTOL and each
length within BLEN_ATOL + BLEN_RTOL len; inferred trees as
torch_port_helpers.assert_same_tree states, RF 0, alpha and p_inv equal.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phylo_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    BLEN_ATOL, BLEN_LL_RTOL, BLEN_RTOL, assert_same_tree, need_cuda,
)
from unicore_tpu_torch.phylo import likelihood as tl
from unicore_tpu_torch.phylo import models as tm
from unicore_tpu_torch.phylo import nj as tnj
from unicore_tpu_torch.phylo import search as ts
from unicore_tpu_torch.phylo.engine import TreeEngine
from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance
from unicore_tpu_torch.synthetic import simulate_msa

LL_RTOL = 1e-5
SITE_ATOL, SITE_RTOL = 1e-4, 1e-3


@pytest.fixture
def tf32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


def _pair(msa, model_str="JTT+F+I+G", alpha=0.7, p_inv=0.05):
    names = list(msa)
    seqs = [msa[k] for k in names]
    freqs = tl.empirical_frequencies(tl.msa_to_codes(names, seqs))
    model = tm.SubstModel.build(tm.ModelSpec.parse(model_str), empirical_freqs=freqs,
                                alpha=alpha, p_inv=p_inv)
    return (tl.LikelihoodEngine(names, seqs, model, device="cpu"),
            tl.LikelihoodEngine(names, seqs, model))


def _nj(msa, floor=1e-3):
    names = list(msa)
    t = tl.make_root_binary(tnj.neighbor_joining(
        tnj.protein_distances(names, [msa[k] for k in names]), names))
    c, b = tl.tree_to_arrays(t, names)
    return c, np.maximum(b, floor)


def _nni_batch(c, b, names):
    arr = [tl.tree_to_arrays(x, names) for x in ts.nni_neighbors(tl.arrays_to_tree(c, b, names))]
    return np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])


def _ll(ref, got, rtol=LL_RTOL):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert np.all(np.abs(got - ref) <= rtol * np.abs(ref)), (ref, got)


def _sites(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.all(np.abs(got - ref) <= SITE_ATOL + SITE_RTOL * np.abs(ref)), np.abs(got - ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("model", [("JTT+F+I+G", 0.7, 0.05), ("JTT+F+I+G", 1.3, 0.0)])
def test_likelihood_cuda_equals_cpu(tf32, model):
    need_cuda()
    msa = simulate_msa(np.random.RandomState(1), 20, 1500)
    cpu, gpu = _pair(msa, *model)
    assert gpu.tips.is_cuda and gpu._mp["U"].is_cuda
    c, b = _nj(msa)
    cb, bb = _nni_batch(c, b, cpu.names)
    _ll(cpu.loglik_batch(cb, bb), gpu.loglik_batch(cb, bb))
    assert torch.get_float32_matmul_precision() == "high"
    _sites(cpu.site_loglik_batch(cb, bb), gpu.site_loglik_batch(cb, bb))
    moves = ts.nni_moves_arrays(c, cpu.n)
    _ll(cpu.loglik_nni_moves(c, b, moves), gpu.loglik_nni_moves(c, b, moves))
    nb_c, ll_c = cpu.optimize_blens(c, b, steps=150)
    nb_g, ll_g = gpu.optimize_blens(c, b, steps=150)
    _ll(ll_c, ll_g, BLEN_LL_RTOL)
    assert np.all(np.abs(nb_g - nb_c) <= BLEN_ATOL + BLEN_RTOL * nb_c)


@pytest.mark.cuda
def test_pattern_chunked_and_incremental_cuda_equal_cpu(tf32, monkeypatch):
    need_cuda()
    msa = simulate_msa(np.random.RandomState(2), 64, 400)
    cpu, gpu = _pair(msa, "JTT+F+G", 0.8, 0.0)
    c, b = _nj(msa, floor=0.02)
    moves = ts.nni_moves_arrays(c, cpu.n)
    _ll(cpu.loglik_nni_moves(c, b, moves), gpu.loglik_nni_moves(c, b, moves))
    monkeypatch.setattr(tl, "pattern_chunk_for", lambda n, C, P, budget_bytes=8e8: 128)
    cb, bb = _nni_batch(c, b, cpu.names)
    _ll(cpu.loglik_batch(cb[:16], bb[:16]), gpu.loglik_batch(cb[:16], bb[:16]))
    _sites(cpu.site_loglik_batch(cb[:8], bb[:8]), gpu.site_loglik_batch(cb[:8], bb[:8]))
    _ll(cpu.optimize_blens(c, b, steps=40)[1], gpu.optimize_blens(c, b, steps=40)[1], BLEN_LL_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,options", [("iqtree", "-m JTT+F+I+G -B 1000"),
                                              ("fasttree", "-gamma -boot 1000")])
def test_tree_engine_infer_cuda_equals_cpu(tf32, schedule, options):
    need_cuda()
    msa = simulate_msa(np.random.RandomState(3), 12, 300)
    gpu_engine = TreeEngine(schedule)
    assert gpu_engine.device.type == "cuda"
    tc, llc, ic = TreeEngine(schedule, device="cpu").infer(msa, options=options)
    tg, llg, ig = gpu_engine.infer(msa, options=options)
    assert rf_distance(parse_newick(tc.to_newick()), parse_newick(tg.to_newick())) == 0
    assert_same_tree(tc, tg)
    _ll(llc, llg, BLEN_LL_RTOL)
    assert (ic["alpha"], ic["p_inv"]) == (ig["alpha"], ig["p_inv"])


@pytest.mark.cuda
def test_loglik_multi_cuda_equals_cpu(tf32):
    """The gene-batched likelihood (phylo/genebatch.py) of three genes with
    their own models, padded to one pattern bucket, on the card and on
    the CPU."""
    from unicore_tpu_torch.phylo import genebatch

    need_cuda()
    engines = {"cpu": [], "cuda": []}
    cbs, bbs = [], []
    for g, L in enumerate((300, 420, 500)):
        msa = simulate_msa(np.random.RandomState(10 + g), 12, L)
        names, seqs = list(msa), list(msa.values())
        model = tm.SubstModel.build(
            tm.ModelSpec.parse("JTT+F+I+G"), alpha=0.5 + 0.5 * g, p_inv=0.03 * g,
            empirical_freqs=tl.empirical_frequencies(tl.msa_to_codes(names, seqs)))
        for dev in engines:
            engines[dev].append(tl.LikelihoodEngine(names, seqs, model, device=dev, pad_patterns_to=512))
        cb, bb = _nni_batch(*_nj(msa), names)
        cbs.append(cb[:16])
        bbs.append(bb[:16])
    cb, bb = np.stack(cbs), np.stack(bbs)
    ref = genebatch.loglik_multi(engines["cpu"], cb, bb)
    got = genebatch.loglik_multi(engines["cuda"], cb, bb)
    assert torch.get_float32_matmul_precision() == "high"
    _ll(ref, got)
    _ll(np.stack([e.loglik_batch(c, b) for e, c, b in zip(engines["cpu"], cb, bb)]), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [3, 9])
def test_partitioned_engine_cuda_matches_cpu_under_tf32(tf32, n_parts):
    """phylo/partition.py's loglik, site_loglik and optimize_blens; nine
    partitions run two chunks of PART_CHUNK, the second padded."""
    need_cuda()
    from unicore_tpu_torch.phylo.partition import PartitionedLikelihoodEngine

    msa = simulate_msa(np.random.RandomState(30 + n_parts), 12, 900)
    names, seqs = list(msa), list(msa.values())
    edges = np.linspace(0, 900, n_parts + 1).astype(int)
    parts = [(f"g{k}", int(edges[k]) + 1, int(edges[k + 1])) for k in range(n_parts)]
    kw = dict(spec=tm.ModelSpec.parse("JTT+F+I+G"), alpha=0.7, p_inv=0.05)
    cpu = PartitionedLikelihoodEngine(names, seqs, parts, device="cpu", **kw)
    gpu = PartitionedLikelihoodEngine(names, seqs, parts, **kw)
    c, b = _nj(msa)
    ll_c, ll_g = cpu.loglik(c, b), gpu.loglik(c, b)
    assert abs(ll_g - ll_c) <= LL_RTOL * abs(ll_c)
    sc, sg = cpu.site_loglik(c, b), gpu.site_loglik(c, b)
    assert np.all(np.abs(sg - sc) <= SITE_ATOL + SITE_RTOL * np.abs(sc))
    bc, lc = cpu.optimize_blens(c, b, steps=30)
    bg, lg = gpu.optimize_blens(c, b, steps=30)
    assert abs(lg - lc) <= BLEN_LL_RTOL * abs(lc)
    assert np.all(np.abs(bg - bc) <= BLEN_ATOL + BLEN_RTOL * bc)
    assert torch.get_float32_matmul_precision() == "high"
