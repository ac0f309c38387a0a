"""The port's batched gene-tree inference (phylo/genebatch.py,
TreeEngine.infer_batched/run_files) against the JAX package's, on the
same numpy-seeded gene MSAs, on the CPU.

Tolerances (both sides float32, as tests/test_torch_phylo.py states):
`_loglik_multi_impl` within LL_RTOL relative; after inference, per gene,
torch_port_helpers.assert_same_gene_tree (RF 0, equal report fields,
lnL within LL_RTOL, lengths and supports as assert_same_tree; where the
two Adam loops end in two optima of one topology's branch lengths, the
port's the higher).  The port's lockstep search also matches its own
solo `infer` (RF 0, lnL within 1e-3 relative), as
tests/test_genetree_batched.py asks of JAX.  The gene-tree module:
tests/test_torch_genetree_module.py."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from torch_port_helpers import (  # noqa: F401
    GENE_LL_RTOL as LL_RTOL, LETTERS, assert_same_gene_tree, gene_msa, one_torch_thread,
    port_env, write_msa,
)
from unicore_tpu.phylo import engine as jeng
from unicore_tpu.phylo import genebatch as jgb
from unicore_tpu.phylo import likelihood as jl
from unicore_tpu.phylo import models as jm
from unicore_tpu.phylo import search as js
from unicore_tpu_torch.phylo import engine as teng
from unicore_tpu_torch.phylo import genebatch as tgb
from unicore_tpu_torch.phylo import likelihood as tl
from unicore_tpu_torch.phylo import models as tm
from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance
from unicore_tpu_torch.runtime import profiling

pytestmark = pytest.mark.usefixtures("one_torch_thread", "port_env")


@pytest.fixture(scope="module")
def genes():
    """tests/test_genetree_batched.py's fixture."""
    rng = np.random.RandomState(42)
    return [
        gene_msa(rng, 5, 60),
        gene_msa(rng, 5, 90),   # same taxa count, different length
        gene_msa(rng, 6, 75),   # different taxa count -> its own group
        gene_msa(rng, 2, 40),   # trivial 2-taxon gene
    ]


@pytest.fixture(scope="module")
def grouped():
    """Three 5-taxa genes of 70-100 columns, all in the (5, 128) group."""
    rng = np.random.RandomState(8)
    return [gene_msa(rng, 5, L) for L in (70, 84, 100)]


def test_loglik_multi_matches_jax_and_per_gene(grouped, monkeypatch):
    """One (G, K) call against the JAX function and the port's per-gene
    `loglik_batch`: genes with their own models (alpha, p_inv, freqs)."""
    import jax.numpy as jnp

    bucket = max(tgb.pattern_bucket(tl.compress_patterns(
        tl.msa_to_codes(list(m), list(m.values())))[0].shape[1]) for m in grouped)
    assert bucket == 128
    jengs, tengs, cbs, bbs = [], [], [], []
    for g, msa in enumerate(grouped):
        names, seqs = list(msa), list(msa.values())
        freqs = jl.empirical_frequencies(jl.msa_to_codes(names, seqs))
        kw = dict(empirical_freqs=freqs, alpha=0.5 + 0.4 * g, p_inv=0.02 * g)
        jengs.append(jl.LikelihoodEngine(names, seqs, jm.SubstModel.build(
            jm.ModelSpec.parse("JTT+F+I+G"), **kw), pad_patterns_to=bucket))
        tengs.append(tl.LikelihoodEngine(names, seqs, tm.SubstModel.build(
            tm.ModelSpec.parse("JTT+F+I+G"), **kw), device="cpu", pad_patterns_to=bucket))
        assert tengs[-1].n_patterns_real == jengs[-1].n_patterns_real < bucket
        assert np.array_equal(tengs[-1].patterns, jengs[-1].patterns)
        assert np.array_equal(tengs[-1].tips.numpy(), np.asarray(jengs[-1].tips))
        root = jl.make_root_binary(jl.unroot(js.random_nni_walk(
            jl.arrays_to_tree(*jl.tree_to_arrays(jl.make_root_binary(
                jeng.neighbor_joining(jeng.protein_distances(names, seqs), names)), names), names),
            np.random.RandomState(g), 2)))
        arr = [jl.tree_to_arrays(c, names) for c in js.nni_neighbors(root)]
        cbs.append(np.stack([a[0] for a in arr]))
        bbs.append(np.maximum(np.stack([a[1] for a in arr]), 1e-3))
    # the candidate counts differ with the rooted shapes: repeat first rows
    K = max(len(c) for c in cbs)
    assert K > min(len(c) for c in cbs)
    cb, bb = (np.stack([np.concatenate([x, np.repeat(x[:1], K - len(x), 0)]) for x in xs])
              for xs in (cbs, bbs))
    ref = np.asarray(jgb._loglik_multi_impl(
        jnp.asarray(cb), jnp.asarray(bb, jnp.float32),
        jnp.stack([e.tips for e in jengs]), jnp.stack([e.w for e in jengs]),
        n_taxa=5, **jgb._stack_model([SimpleNamespace(engine=e) for e in jengs])))
    profiling.reset_counters()
    got = tgb.loglik_multi(tengs, cb, bb)
    assert got.shape == ref.shape == (3, cb.shape[1])
    assert np.all(np.abs(got - ref) <= LL_RTOL * np.abs(ref)), (ref, got)
    per_gene = np.stack([e.loglik_batch(c, b) for e, c, b in zip(tengs, cb, bb)])
    assert np.all(np.abs(got - per_gene) <= LL_RTOL * np.abs(per_gene)), (per_gene, got)
    assert profiling.get_counters()["phylo.candidates"] == 2 * cb.shape[0] * cb.shape[1]
    # a budget of one gene per call gives the same numbers
    monkeypatch.setattr(tgb, "GENE_BATCH_BYTES", 1)
    assert np.array_equal(tgb.loglik_multi(tengs, cb, bb), got)


def test_subsampled_engine_keeps_n_patterns_real():
    msa = {f"t{i}": "".join(np.random.RandomState(i).choice(list(LETTERS), 300)) for i in range(4)}
    names, seqs = list(msa), list(msa.values())
    model = tm.SubstModel.build(tm.ModelSpec.parse("JTT"), empirical_freqs=np.full(20, 0.05))
    eng = tl.LikelihoodEngine(names, seqs, model, device="cpu", pad_patterns_to=512)
    sub = tl.subsampled_engine(eng, k=64)
    jsub = jl.subsampled_engine(jl.LikelihoodEngine(names, seqs, jm.SubstModel.build(
        jm.ModelSpec.parse("JTT"), empirical_freqs=np.full(20, 0.05)), pad_patterns_to=512), k=64)
    assert (eng.n_patterns_real, sub.n_patterns_real) == (300, jsub.n_patterns_real)
    assert np.array_equal(sub.weights, jsub.weights)


def test_lockstep_matches_jax_and_solo_infer(genes, grouped):
    eng = teng.TreeEngine("fasttree")
    msas = genes + grouped[:2]
    profiling.reset_counters()
    batched = eng.infer_batched(msas, options="-gamma")
    c = profiling.get_counters()
    assert (c["phylo.genes"], c["phylo.gene_groups"]) == (6, 3)  # (5, 64), (5, 128) x 3, (6, 128)
    same = []
    for msa, ref, got in zip(msas, jeng.TreeEngine("fasttree").infer_batched(msas, options="-gamma"),
                             batched):
        if len(msa) < 3:
            assert got[0].to_newick() == ref[0].to_newick() and got[1:] == ref[1:]
            continue
        same.append(assert_same_gene_tree(msa, ref, got, supported=False))
    assert sum(same) >= len(same) - 1, same
    for msa, (bt, bll, binfo) in zip(genes, batched):  # the JAX test, on the port
        if len(msa) < 3:
            assert {n.name for n in bt.leaves()} == set(msa)
            continue
        st, sll, sinfo = eng.infer(msa, options="-gamma")
        assert rf_distance(bt, st) == 0, (bt.to_newick(), st.to_newick())
        assert abs(bll - sll) < 1e-3 * max(1.0, abs(sll)), (bll, sll)
        assert binfo["n_patterns"] == sinfo["n_patterns"]  # real, not padded


def test_run_files_writes_per_gene_outputs(genes, tmp_path):
    """Per-gene files of the builder's name over each gene's taxa, with
    the topology of JAX's files (their numbers: the test above)."""
    fastas = []
    for g, msa in enumerate(genes[:3]):
        fastas.append(str(tmp_path / f"g{g}.fa"))
        write_msa(fastas[-1], msa)
    jpaths = jeng.TreeEngine("fasttree").run_files(
        fastas, [str(tmp_path / f"jax{g}") for g in range(3)], options="-gamma")
    tpaths = teng.TreeEngine("fasttree").run_files(
        fastas, [str(tmp_path / f"port{g}") for g in range(3)], options="-gamma")
    for jp, tp, msa in zip(jpaths, tpaths, genes[:3]):
        assert tp == str(tmp_path / f"port{genes.index(msa)}" / "fasttree.nwk")
        assert os.path.basename(jp) == "fasttree.nwk"
        t = parse_newick(open(tp).read().strip())
        assert {n.name for n in t.leaves()} == set(msa)
        assert rf_distance(parse_newick(open(jp).read().strip()), t) == 0
