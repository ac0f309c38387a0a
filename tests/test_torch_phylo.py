"""The port's phylo package (unicore_tpu_torch/phylo) against the JAX
package's (unicore_tpu/phylo) on the same numpy-seeded inputs, on the CPU.

Tolerances (both sides compute in float32; the JAX side is XLA on the CPU):
  * model arrays and the empirical tables: np.array_equal;
  * Newick strings, bipartitions, NJ trees, NNI move lists: equal;
  * lnL of `loglik`, `loglik_batch`, `loglik_nni_moves` and the
    pattern-chunked path: |dlnL| <= LL_RTOL * |lnL|;
  * per-pattern log-likelihoods (`site_loglik(_batch)`):
    |d| <= SITE_ATOL + SITE_RTOL * |s|.  Not the 1e-4 absolute first asked
    for: P(t) = U exp(L t) U^-1 is rebuilt in float32 with U entries up to
    1/sqrt(min pi), so its small off-diagonal entries at short branches
    carry a rounding noise the two backends draw differently, and a column
    that changes state across such a branch moves with it (on the NNI
    candidates of NJ trees with 1e-3 branches, a few columns per tree
    exceed 1e-4 absolute).  The weighted sum over columns averages it out,
    which LL_RTOL holds;
  * `optimize_blens` (150 Adam steps): |dlnL| <= BLEN_LL_RTOL * |lnL|,
    each length within BLEN_ATOL + BLEN_RTOL * len;
  * `TreeSearch.optimize` and `TreeEngine.infer` (iqtree, fasttree,
    raxml-ng): RF 0, lnL within BLEN_LL_RTOL, alpha and p_inv equal,
    lengths and UFBoot supports as torch_port_helpers.assert_same_tree
    states (within SUPPORT_POINTS);
  * `ufboot_supports` and `rell_supports` fed the same site
    log-likelihoods (a stub engine): equal.
"""

import zlib

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    BLEN_ATOL, BLEN_LL_RTOL, BLEN_RTOL, assert_same_tree, one_torch_thread, port_env,
)
from unicore_tpu.phylo import bootstrap as jb
from unicore_tpu.phylo import empirical as jemp
from unicore_tpu.phylo import engine as jeng
from unicore_tpu.phylo import likelihood as jl
from unicore_tpu.phylo import models as jm
from unicore_tpu.phylo import newick as jn
from unicore_tpu.phylo import nj as jnj
from unicore_tpu.phylo import search as js
from unicore_tpu_torch.phylo import bootstrap as tb
from unicore_tpu_torch.phylo import empirical as temp
from unicore_tpu_torch.phylo import engine as teng
from unicore_tpu_torch.phylo import likelihood as tl
from unicore_tpu_torch.phylo import models as tm
from unicore_tpu_torch.phylo import newick as tn
from unicore_tpu_torch.phylo import nj as tnj
from unicore_tpu_torch.phylo import search as ts
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.synthetic import simulate_msa

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LL_RTOL = 1e-5
SITE_ATOL, SITE_RTOL = 1e-4, 1e-3
CPU = torch.device("cpu")

MODELS = [("JTT+F+I+G", 0.7, 0.05), ("JTT+F+I+G", 1.3, 0.0), ("WAG+G", 0.5, 0.0),
          ("LG+I", 1.0, 0.1), ("POISSON+F", 1.0, 0.0), ("BLOSUM62+G6", 2.0, 0.0)]


def _msa(seed, n, L):
    return simulate_msa(np.random.RandomState(seed), n, L)


def _engines(msa, model_str="JTT+F+I+G", alpha=0.7, p_inv=0.05):
    names = list(msa)
    seqs = [msa[k] for k in names]
    freqs = jl.empirical_frequencies(jl.msa_to_codes(names, seqs))
    jmod = jm.SubstModel.build(jm.ModelSpec.parse(model_str), empirical_freqs=freqs,
                               alpha=alpha, p_inv=p_inv)
    tmod = tm.SubstModel.build(tm.ModelSpec.parse(model_str), empirical_freqs=freqs,
                               alpha=alpha, p_inv=p_inv)
    return jl.LikelihoodEngine(names, seqs, jmod), tl.LikelihoodEngine(names, seqs, tmod, device=CPU)


def _nj_arrays(msa, floor=1e-3):
    names = list(msa)
    t = jl.make_root_binary(jnj.neighbor_joining(
        jnj.protein_distances(names, [msa[k] for k in names]), names))
    c, b = jl.tree_to_arrays(t, names)
    return c, np.maximum(b, floor)


def _nni_batch(c, b, names):
    cands = js.nni_neighbors(jl.arrays_to_tree(c, b, names))
    arr = [jl.tree_to_arrays(x, names) for x in cands]
    return np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])


def assert_ll(ref, got, rtol=LL_RTOL):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert np.all(np.abs(got - ref) <= rtol * np.abs(ref)), (ref, got)


def assert_sites(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    bad = np.abs(got - ref) > SITE_ATOL + SITE_RTOL * np.abs(ref)
    assert not bad.any(), (np.abs(got - ref).max(), ref[bad][:5], got[bad][:5])


def assert_blens(ref, got):
    assert np.all(np.abs(got - ref) <= BLEN_ATOL + BLEN_RTOL * np.abs(ref)), (ref, got)


def supports(tree):
    return {k: v.support for k, v in jn.bipartitions(tree).items()}


# ---------------------------------------------------------------------------
# host modules: copies, equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["JTT", "WAG", "LG"])
def test_empirical_tables_equal(name):
    assert temp.has_model(name) and temp.has_model(name.lower())
    R1, f1 = jemp.empirical_model(name)
    R2, f2 = temp.empirical_model(name)
    assert np.array_equal(R1, R2) and np.array_equal(f1, f2)
    assert R2.shape == (20, 20) and np.array_equal(R2, R2.T)


@pytest.mark.parametrize("model_str,alpha,p_inv", MODELS)
def test_subst_model_arrays_equal(model_str, alpha, p_inv):
    freqs = np.random.RandomState(3).dirichlet(np.ones(20) * 5)
    a = jm.SubstModel.build(jm.ModelSpec.parse(model_str), empirical_freqs=freqs,
                            alpha=alpha, p_inv=p_inv)
    b = tm.SubstModel.build(tm.ModelSpec.parse(model_str), empirical_freqs=freqs,
                            alpha=alpha, p_inv=p_inv)
    assert vars(a.spec) == vars(b.spec)
    for f in ("pi", "eigvals", "U", "Uinv"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.rates_and_props(), b.rates_and_props()):
        assert np.array_equal(x, y)
    t = np.array([0.0, 0.01, 0.3, 2.0])
    assert np.array_equal(a.transition_matrices(t), b.transition_matrices(t))
    for ncat in (1, 4, 6):
        assert np.array_equal(jm.gamma_rates(alpha, ncat), tm.gamma_rates(alpha, ncat))


def test_newick_bipartitions_and_rf_equal():
    text = "((a:0.1,b:0.2)87:0.05,(c:0.15,(d:0.1,e:0.3)42:0.2):0.07,f:0.3);"
    other = "((a:0.1,c:0.2):0.05,(b:0.15,(d:0.1,e:0.3)):0.07,f:0.3);"
    ja, ta = jn.parse_newick(text), tn.parse_newick(text)
    for ws in (True, False):
        assert ja.to_newick(with_support=ws) == ta.to_newick(with_support=ws)
    assert ta.to_newick() == text
    assert set(jn.bipartitions(ja)) == set(tn.bipartitions(ta))
    assert set(jn.bipartitions(ja, restrict=frozenset("abcd"))) == \
        set(tn.bipartitions(ta, restrict=frozenset("abcd")))
    assert jn.rf_distance(ja, jn.parse_newick(other)) == \
        tn.rf_distance(ta, tn.parse_newick(other)) > 0


def test_nj_and_patterns_equal():
    msa = _msa(4, 9, 150)
    names, seqs = list(msa), list(msa.values())
    D1, D2 = jnj.protein_distances(names, seqs), tnj.protein_distances(names, seqs)
    assert np.array_equal(D1, D2)
    assert jnj.neighbor_joining(D1, names).to_newick() == tnj.neighbor_joining(D2, names).to_newick()
    codes = jl.msa_to_codes(names, seqs)
    assert np.array_equal(codes, tl.msa_to_codes(names, seqs))
    for x, y in zip(jl.compress_patterns(codes), tl.compress_patterns(codes)):
        assert np.array_equal(x, y)
    assert np.array_equal(jl.empirical_frequencies(codes), tl.empirical_frequencies(codes))
    for n, C, P in [(20, 5, 37073), (100, 4, 85000), (8, 4, 500), (64, 5, 8192)]:
        assert jl.pattern_chunk_for(n, C, P) == tl.pattern_chunk_for(n, C, P)


def test_nni_moves_and_neighbors_equal():
    msa = _msa(5, 11, 60)
    names = list(msa)
    c, b = _nj_arrays(msa)
    n = len(names)
    moves = js.nni_moves_arrays(c, n)
    assert moves == ts.nni_moves_arrays(c, n)
    for m in moves:
        assert np.array_equal(js.apply_nni_move(c, m), ts.apply_nni_move(c, m))
    root = jl.arrays_to_tree(c, b, names)
    troot = tl.arrays_to_tree(c, b, names)
    assert [t.to_newick() for t in js.nni_neighbors(root)] == \
        [t.to_newick() for t in ts.nni_neighbors(troot)]
    assert js.TreeSearch(None, seed=3).perturb(root, 4).to_newick() == \
        ts.TreeSearch(None, seed=3).perturb(troot, 4).to_newick()
    ju, tu = jl.unroot(jl.arrays_to_tree(c, b, names)), tl.unroot(tl.arrays_to_tree(c, b, names))
    assert ju.to_newick() == tu.to_newick()
    ct, bt = tl.tree_to_arrays(tl.make_root_binary(tu), names)
    cj, bj = jl.tree_to_arrays(jl.make_root_binary(ju), names)
    assert np.array_equal(ct, cj) and np.array_equal(bt, bj)


# ---------------------------------------------------------------------------
# likelihood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_str,alpha,p_inv", MODELS[:4])
def test_loglik_paths_match_jax(model_str, alpha, p_inv):
    """loglik, loglik_batch, site_loglik(_batch), loglik_nni_moves on
    identical float32 inputs; p_inv = 0 puts log(0) = -inf into the
    category mix (the +I+G case with alpha 1.3)."""
    msa = _msa(7, 10, 120)
    je, te = _engines(msa, model_str, alpha, p_inv)
    assert te.tips.dtype == torch.float32 and te.tips.device == CPU
    assert np.array_equal(je.weights, te.weights)
    c, b = _nj_arrays(msa)
    assert_ll(je.loglik(c, b), te.loglik(c, b))
    assert_sites(je.site_loglik(c, b), te.site_loglik(c, b))
    cb, bb = _nni_batch(c, b, je.names)
    lls = te.loglik_batch(cb, bb)
    assert lls.dtype == np.float32 and lls.shape == (len(cb),)
    assert_ll(je.loglik_batch(cb, bb), lls)
    assert_ll(te.loglik_batch(cb, bb, chunk=3), lls, rtol=0)
    assert_sites(je.site_loglik_batch(cb, bb), te.site_loglik_batch(cb, bb, chunk=5))
    moves = js.nni_moves_arrays(c, te.n)
    inc = te.loglik_nni_moves(c, b, moves, chunk=7)
    assert_ll(je.loglik_nni_moves(c, b, moves), inc)
    assert np.isfinite(inc).all()


def test_p_inv_zero_gradient_is_finite():
    """props[0] = 0 with +I: log(0) = -inf inside logsumexp must give the
    lnL JAX gives and a finite gradient (optimize_blens)."""
    msa = _msa(8, 8, 100)
    je, te = _engines(msa, "JTT+F+I+G", 1.0, 0.0)
    assert float(te._mp["props"][0]) == 0.0
    c, b = _nj_arrays(msa)
    assert_ll(je.loglik(c, b), te.loglik(c, b))
    x = torch.tensor(b, dtype=torch.float32, requires_grad=True)
    ll = (tl._site_loglik_tree(c, x, te.tips, **te._mp) * te.w).sum()
    (g,) = torch.autograd.grad(ll, x)
    assert torch.isfinite(ll) and torch.isfinite(g).all()
    assert_ll(je.loglik(c, b), float(ll.detach()))
    nb, nll = te.optimize_blens(c, b, steps=30)
    jb_, jll = je.optimize_blens(c, b, steps=30)
    assert np.isfinite(nb).all()
    assert_ll(jll, nll, rtol=BLEN_LL_RTOL)


@pytest.mark.parametrize("model_str,alpha,p_inv", [MODELS[0], MODELS[2]])
def test_optimize_blens_matches_jax(model_str, alpha, p_inv):
    msa = _msa(9, 10, 150)
    je, te = _engines(msa, model_str, alpha, p_inv)
    c, b = _nj_arrays(msa)
    jb_, jll = je.optimize_blens(c, b, steps=150)
    profiling.reset_counters()
    tb_, tll = te.optimize_blens(c, b, steps=150)
    assert profiling.get_counters()["phylo.blen_steps"] == 150
    assert_ll(jll, tll, rtol=BLEN_LL_RTOL)
    assert_blens(jb_, tb_)
    assert tb_[-1] == 0.0 and tll > te.loglik(c, b)


def test_pattern_chunked_paths_match_jax(monkeypatch):
    """Force pattern chunking (128 patterns) on both sides: padded chunks
    summed for lnL, concatenated for sites, per-chunk gradients summed in
    the Adam loop; the port's chunked results also match its unchunked."""
    msa = _msa(10, 7, 700)
    je, te = _engines(msa, "JTT+G", 0.8, 0.0)
    P = int(te.tips.shape[1])
    assert P > 3 * 128
    c, b = _nj_arrays(msa)
    cb, bb = _nni_batch(c, b, je.names)
    ref = (te.loglik_batch(cb, bb), te.site_loglik_batch(cb, bb), te.optimize_blens(c, b, steps=40))

    def small(n, C, P, budget_bytes=8e8):
        return 128

    monkeypatch.setattr(jl, "pattern_chunk_for", small)
    monkeypatch.setattr(tl, "pattern_chunk_for", small)
    lls = te.loglik_batch(cb, bb)
    sites = te.site_loglik_batch(cb, bb)
    assert sites.shape == (len(cb), P)
    assert_ll(je.loglik_batch(cb, bb), lls)
    assert_sites(je.site_loglik_batch(cb, bb), sites)
    nb, nll = te.optimize_blens(c, b, steps=40)
    jb_, jll = je.optimize_blens(c, b, steps=40)
    assert_ll(jll, nll, rtol=BLEN_LL_RTOL)
    assert_blens(jb_, nb)
    assert_ll(ref[0], lls)
    assert_sites(ref[1], sites)
    assert_ll(ref[2][1], nll, rtol=BLEN_LL_RTOL)
    padded, w = tl._pad_patterns(te.tips, te.w, 128)
    assert padded.shape[1] % 128 == 0 and float(w[P:].abs().sum()) == 0.0
    assert bool((padded[:, P:] == 1).all())


def test_subsampled_engine_draws_equal_jax():
    msa = _msa(11, 6, 400)
    je, te = _engines(msa)
    k = 64
    js_, ts_ = jl.subsampled_engine(je, k=k), tl.subsampled_engine(te, k=k)
    assert ts_ is not te and ts_.device == te.device
    assert np.array_equal(js_.patterns, ts_.patterns)
    assert np.array_equal(js_.weights, ts_.weights)
    assert np.array_equal(np.asarray(js_.tips), ts_.tips.numpy())
    c, b = _nj_arrays(msa)
    assert_ll(js_.loglik(c, b), ts_.loglik(c, b))
    assert tl.subsampled_engine(te, k=10 ** 6) is te


def test_incremental_path_48_taxa_matches_full_batch():
    """loglik_nni_moves (partial-CLV chains, stable ids) equals the full
    evaluation of each canonicalized swapped tree, and JAX's chains."""
    msa = _msa(12, 48, 50)
    je, te = _engines(msa, "JTT+F+G", 0.8, 0.0)
    names = te.names
    c, b = _nj_arrays(msa, floor=0.02)
    moves = ts.nni_moves_arrays(c, te.n)
    inc = te.loglik_nni_moves(c, b, moves)
    full = []
    for m in moves:
        c2, b2 = tl.tree_to_arrays(tl.arrays_to_tree(ts.apply_nni_move(c, m), b, names), names)
        full.append((c2, b2))
    full_ll = te.loglik_batch(np.stack([x[0] for x in full]), np.stack([x[1] for x in full]))
    assert_ll(full_ll, inc)
    assert_ll(je.loglik_nni_moves(c, b, moves), inc)


def test_full_fp32_guard_restores_precision():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with tl.full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        msa = _msa(13, 6, 80)
        je, te = _engines(msa)
        c, b = _nj_arrays(msa)
        assert_ll(je.loglik(c, b), te.loglik(c, b))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# search and bootstrap
# ---------------------------------------------------------------------------

def test_tree_search_optimize_matches_jax():
    msa = _msa(14, 10, 200)
    je, te = _engines(msa, "JTT+F", 1.0, 0.0)
    names = te.names
    start = tnj.neighbor_joining(tnj.protein_distances(names, list(msa.values())), names)
    jt, jll = js.TreeSearch(je).optimize(jn.parse_newick(start.to_newick()), max_rounds=10,
                                         blen_steps=80)
    profiling.reset_counters()
    tt, tll = ts.TreeSearch(te).optimize(start, max_rounds=10, blen_steps=80)
    assert jn.rf_distance(jt, jn.parse_newick(tt.to_newick())) == 0
    assert_ll(jll, tll, rtol=BLEN_LL_RTOL)
    cnt = profiling.get_counters()
    assert cnt["phylo.candidates"] >= 2 * (te.n - 2) and cnt["phylo.blen_steps"] >= 160


def test_search_48_taxa_uses_incremental_path():
    msa = _msa(15, 48, 50)
    je, te = _engines(msa, "JTT+F", 1.0, 0.0)
    names = te.names
    start = tnj.neighbor_joining(tnj.protein_distances(names, list(msa.values())), names)
    calls = []
    real = te.loglik_nni_moves
    te.loglik_nni_moves = lambda *a, **k: calls.append(1) or real(*a, **k)
    tt, tll = ts.TreeSearch(te).optimize(start, max_rounds=2, blen_steps=40)
    jt, jll = js.TreeSearch(je).optimize(jn.parse_newick(start.to_newick()), max_rounds=2,
                                         blen_steps=40)
    assert calls and np.isfinite(tll)
    assert sorted(l.name for l in tt.leaves()) == sorted(names)
    assert jn.rf_distance(jt, jn.parse_newick(tt.to_newick())) == 0
    assert_ll(jll, tll, rtol=BLEN_LL_RTOL)


class _StubEngine:
    """Fixed per-pattern log-likelihoods, a function of the topology's
    bipartitions only, so both packages' UFBoot climbs see the same
    numbers."""

    def __init__(self, lik, names, P, seed):
        self.lik, self.names, self.n = lik, list(names), len(names)
        self.weights = np.random.RandomState(seed).randint(1, 4, P).astype(np.float32)
        self.P = P

    def site_loglik(self, c, b):
        return self.site_loglik_batch(c[None], b[None])[0]

    def site_loglik_batch(self, cb, bb):
        out = []
        for c, b in zip(cb, bb):
            keys = sorted(",".join(sorted(k)) for k in
                          jn.bipartitions(self.lik.arrays_to_tree(c, b, self.names)))
            rng = np.random.RandomState(zlib.crc32("|".join(keys).encode()))
            out.append((-3.0 + 0.05 * rng.randn(self.P)).astype(np.float32))
        return np.stack(out)


@pytest.mark.parametrize("n_boot,seed", [(1000, 12345), (57, 3)])
def test_ufboot_supports_equal_jax_on_the_same_site_logliks(n_boot, seed):
    msa = _msa(16, 9, 40)
    names = list(msa)
    c, b = _nj_arrays(msa)
    tree = jl.unroot(jl.arrays_to_tree(c, b, names))
    ja = jb.ufboot_supports(_StubEngine(jl, names, 60, 1), jn.parse_newick(tree.to_newick()),
                            n_boot=n_boot, seed=seed)
    ta = tb.ufboot_supports(_StubEngine(tl, names, 60, 1), tn.parse_newick(tree.to_newick()),
                            n_boot=n_boot, seed=seed)
    assert ja.to_newick() == ta.to_newick()
    assert any(v is not None and v < 100 for v in supports(ja).values())
    w = np.random.RandomState(2).randint(1, 5, 33).astype(np.float64)
    assert np.array_equal(jb.bootstrap_weights(w, n_boot, seed), tb.bootstrap_weights(w, n_boot, seed))


def test_ufboot_binary_root_with_internal_children_equals_jax():
    """Both root children internal: the labels, and the tree unroot()
    makes of them, equal JAX's (which labels only the second child, so
    the unrooted tree carries no support on the root split)."""
    names = [f"t{i}" for i in range(6)]
    text = "((t0:0.1,(t1:0.2,t2:0.1):0.1):0.2,((t3:0.1,t4:0.1):0.1,t5:0.3):0.2);"
    ja = jb.ufboot_supports(_StubEngine(jl, names, 50, 2), jn.parse_newick(text), n_boot=200, seed=4)
    ta = tb.ufboot_supports(_StubEngine(tl, names, 50, 2), tn.parse_newick(text), n_boot=200, seed=4)
    assert ja.to_newick() == ta.to_newick()
    assert ta.children[0].support is None and ta.children[1].support is not None
    assert jl.unroot(ja).to_newick() == tl.unroot(ta).to_newick()


def test_rell_supports_equal_jax():
    msa = _msa(17, 7, 30)
    names = list(msa)
    c, b = _nj_arrays(msa)
    base = jl.arrays_to_tree(c, b, names)
    cands = [jl.arrays_to_tree(*jl.tree_to_arrays(t, names), names) for t in js.nni_neighbors(base)]
    sl = np.random.RandomState(5).randn(len(cands), 45).astype(np.float32) - 3
    w = np.random.RandomState(6).randint(1, 4, 45).astype(np.float64)
    ja = jb.rell_supports(jn.parse_newick(base.to_newick()), cands, sl, w, n_reps=300, seed=1)
    ta = tb.rell_supports(tn.parse_newick(base.to_newick()),
                          [tn.parse_newick(t.to_newick()) for t in cands], sl, w, n_reps=300, seed=1)
    assert ja.to_newick() == ta.to_newick()


# ---------------------------------------------------------------------------
# the engine: three schedules
# ---------------------------------------------------------------------------

SCHEDULES = [("iqtree", "-m JTT+F+I+G -B 1000"), ("fasttree", "-gamma -boot 1000"),
             ("raxml-ng", "--model JTT+F+I+G --seed 12345 --all --tree pars{90},rand{10}")]


@pytest.mark.parametrize("schedule,options", SCHEDULES)
def test_tree_engine_infer_matches_jax(port_env, schedule, options):  # noqa: F811
    msa = _msa(18, 8, 160)
    jt, jll, ji = jeng.TreeEngine(schedule).infer(msa, options=options)
    profiling.reset_counters()
    eng = teng.TreeEngine(schedule)
    assert eng.device == CPU
    tt, tll, ti = eng.infer(msa, options=options)
    assert jn.rf_distance(jt, jn.parse_newick(tt.to_newick())) == 0
    assert_same_tree(jt, tt)
    assert_ll(jll, tll, rtol=BLEN_LL_RTOL)
    assert (ji["alpha"], ji["p_inv"]) == (ti["alpha"], ti["p_inv"])
    assert {k: v for k, v in ji.items() if k not in ("lnL", "seconds")} == \
        {k: v for k, v in ti.items() if k not in ("lnL", "seconds")}
    cnt = profiling.get_counters()
    assert cnt["phylo.patterns"] == ti["n_patterns"] and cnt["phylo.seconds"] > 0
    assert cnt["phylo.candidates"] > 0 and cnt["phylo.blen_steps"] > 0


def test_tree_engine_small_inputs_and_typed_exits(port_env, tmp_path):  # noqa: F811
    eng = teng.TreeEngine("iqtree")
    assert eng.probe()
    for msa in ({"a": "ACDE"}, {"a": "ACDE", "b": "ACDF"}):
        t1, ll1, i1 = jeng.TreeEngine("iqtree").infer(msa)
        t2, ll2, i2 = eng.infer(msa)
        assert (t1.to_newick(), ll1, i1) == (t2.to_newick(), ll2, i2)
    # a partition file (-p/-q) was the typed "not yet ported" exit; it now
    # runs the partitioned model, in infer and in the batched entries
    part = tmp_path / "p.txt"
    part.write_text("JTT, g1=1-2\nJTT, g2=3-4\n")
    msa3 = {"a": "ACDE", "b": "ACDF", "c": "ACDF"}
    for opts in (f"-m JTT -p {part}", f"-m JTT -q {part}"):
        t1, ll1, i1 = jeng.TreeEngine("iqtree").infer(msa3, options=opts)
        t2, ll2, i2 = eng.infer(msa3, options=opts)
        assert abs(ll2 - ll1) <= 1e-4 * abs(ll1)
        assert {k: v for k, v in i1.items() if k not in ("lnL", "seconds")} == \
            {k: v for k, v in i2.items() if k not in ("lnL", "seconds")}
        assert i2["n_partitions"] == 2
        assert sorted(x.name for x in t2.leaves()) == ["a", "b", "c"]
    # the batched gene-tree entries send partitioned genes to infer
    msa_file = tmp_path / "g.fa"
    msa_file.write_text(">a\nACDE\n>b\nACDF\n>c\nACDF\n")
    (bt, bll, binfo), = eng.infer_batched([msa3], options=f"-m JTT -p {part}")
    assert binfo["n_partitions"] == 2 and abs(bll - ll2) <= 1e-4 * abs(ll2)
    eng.run_files([str(msa_file)], [str(tmp_path / "o")], options=f"-m JTT -q {part}")
    assert "n_partitions: 2" in (tmp_path / "o" / "iqtree.iqtree").read_text()


def test_species_tree_is_the_tree_write_proteomes_used(tmp_path, monkeypatch):
    from unicore_tpu_torch import synthetic

    used = []
    real = synthetic.random_tree

    def recording(rng, species, depth):
        used.append(real(rng, species, depth))
        return used[-1]

    monkeypatch.setattr(synthetic, "random_tree", recording)
    synthetic.write_proteomes(str(tmp_path / "in"), 7, 12, seed=7)
    monkeypatch.undo()
    (edge_list, root), = used
    tree = synthetic.species_tree(7, 7)
    assert sorted(l.name for l in tree.leaves()) == [f"sp{i:02d}" for i in range(7)]
    assert sorted(p.stem for p in (tmp_path / "in").iterdir()) == \
        sorted(l.name for l in tree.leaves())
    # the same edges: each child's leaf set hangs below its parent with its length
    names = [f"sp{i:02d}" for i in range(7)]
    below = {i: frozenset([n]) for i, n in enumerate(names)}
    for p, c, _ in edge_list:
        below[p] = below.get(p, frozenset()) | below[c]
    want = {below[c]: length for p, c, length in edge_list}
    got = {frozenset(l.name for l in n.leaves()): n.length
           for n in tree.postorder() if n is not tree}
    assert got == want and below[root] == frozenset(names)
