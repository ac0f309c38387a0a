"""The port's partitioned likelihood (phylo/partition.py) and `-p`/`-q`
inference against the JAX package's, on the CPU, on alignments made from
a numpy seed.  Tolerances as tests/test_torch_phylo.py: lnL within 1e-5
relative, sites within 1e-4 + 1e-3 |s|, after Adam lnL within 1e-4
relative and lengths within 1e-3 + 1e-2 len; trees as unrooted splits
(torch_port_helpers.assert_same_tree)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401  (fixtures)
    BLEN_ATOL, BLEN_LL_RTOL, BLEN_RTOL, GENE_LL_RTOL, assert_same_tree, files_of, gene_msa,
    one_torch_thread, port_env, write_msa,
)
from unicore_tpu.cli import main as jax_main
from unicore_tpu.phylo import engine as jeng
from unicore_tpu.phylo import models as jm
from unicore_tpu.phylo import partition as jp
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.phylo import engine as teng
from unicore_tpu_torch.phylo import likelihood as tl
from unicore_tpu_torch.phylo import models as tm
from unicore_tpu_torch.phylo import partition as tp
from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance
from unicore_tpu_torch.phylo.nj import neighbor_joining, protein_distances

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LL_RTOL, SITE_ATOL, SITE_RTOL = 1e-5, 1e-4, 1e-3
MODEL = "JTT+F+I+G"


def _msa(seed=3, n=6, L=180):
    return gene_msa(np.random.RandomState(seed), n, L)


def _parts(n_parts, L=180):
    """n_parts contiguous partitions tiling L columns."""
    edges = np.linspace(0, L, n_parts + 1).astype(int)
    return [(f"g{k}", int(edges[k]) + 1, int(edges[k + 1])) for k in range(n_parts)]


def _engines(msa, parts, alpha=0.7, p_inv=0.05):
    names, seqs = list(msa), list(msa.values())
    j = jp.PartitionedLikelihoodEngine(names, seqs, parts, spec=jm.ModelSpec.parse(MODEL),
                                       alpha=alpha, p_inv=p_inv)
    t = tp.PartitionedLikelihoodEngine(names, seqs, parts, spec=tm.ModelSpec.parse(MODEL),
                                       alpha=alpha, p_inv=p_inv, device="cpu")
    return j, t


def _nj_tree(msa, floor=1e-3):
    names = list(msa)
    root = tl.make_root_binary(neighbor_joining(protein_distances(names, list(msa.values())), names))
    c, b = tl.tree_to_arrays(root, names)
    return c, np.maximum(b, floor)


def _site_err(ref, got):
    assert ref.shape == got.shape
    return float(np.max(np.abs(got - ref) / (SITE_ATOL + SITE_RTOL * np.abs(ref))))


def test_parse_partition_file_matches_jax(tmp_path):
    p = tmp_path / "parts"
    p.write_text("JTT+F+I+G, gene1=1-20\n\nJTT+F+I+G, gene2 = 21-30\nnot a partition line\n"
                 "LG,g3 =31 - 40\n")
    assert tp.parse_partition_file(str(p)) == jp.parse_partition_file(str(p)) == \
        [("gene1", 1, 20), ("gene2", 21, 30), ("g3", 31, 40)]


@pytest.mark.parametrize("n_parts", [2, 9])
def test_loglik_and_sites_match_jax(n_parts):
    """Nine partitions cross PART_CHUNK: a second chunk and padded
    partitions run."""
    msa = _msa()
    j, t = _engines(msa, _parts(n_parts))
    assert (t.G, t.L, t.Pmax, t._G_pad) == (j.G, j.L, j.Pmax, j._G_pad)
    assert np.array_equal(t.weights, j.weights)
    assert t._G_pad == (8 if n_parts == 2 else 16)
    c, b = _nj_tree(msa)
    ref, got = j.loglik(c, b), t.loglik(c, b)
    assert abs(got - ref) <= LL_RTOL * abs(ref), (ref, got)
    assert _site_err(j.site_loglik(c, b), t.site_loglik(c, b)) <= 1.0
    cb = np.stack([c, c[:, ::-1]])
    bb = np.stack([b, b * 1.5])
    assert np.allclose(t.loglik_batch(cb, bb), j.loglik_batch(cb, bb), rtol=LL_RTOL, atol=0)
    # the duck type that keeps search and bootstrap on the full data
    for attr in ("tips", "patterns", "loglik_nni_moves", "site_loglik_batch"):
        assert not hasattr(t, attr), attr


@pytest.mark.parametrize("n_parts", [2, 9])
def test_optimize_blens_matches_jax(n_parts):
    msa = _msa(seed=4)
    j, t = _engines(msa, _parts(n_parts))
    c, b = _nj_tree(msa, floor=0.05)
    jb, jll = j.optimize_blens(c, b, steps=30)
    tb, tll = t.optimize_blens(c, b, steps=30)
    assert abs(tll - jll) <= BLEN_LL_RTOL * abs(jll), (jll, tll)
    assert np.all(np.abs(tb - jb) <= BLEN_ATOL + BLEN_RTOL * jb), (jb, tb)
    assert tb[-1] == 0.0 and tll > t.loglik(c, b)


def test_set_model_matches_jax():
    msa = _msa(seed=5)
    j, t = _engines(msa, _parts(3))
    names, seqs = list(msa), list(msa.values())
    freqs = tl.empirical_frequencies(tl.msa_to_codes(names, seqs))
    for alpha, p_inv in ((1.5, 0.0), (0.4, 0.1)):
        j.set_model(jm.SubstModel.build(jm.ModelSpec.parse(MODEL), empirical_freqs=freqs,
                                        alpha=alpha, p_inv=p_inv))
        t.set_model(tm.SubstModel.build(tm.ModelSpec.parse(MODEL), empirical_freqs=freqs,
                                        alpha=alpha, p_inv=p_inv))
        assert (t.model.alpha, t.model.p_inv) == (alpha, p_inv)
        assert np.array_equal(t.model.pi, j.model.pi)
        c, b = _nj_tree(msa)
        ref, got = j.loglik(c, b), t.loglik(c, b)
        assert abs(got - ref) <= LL_RTOL * abs(ref), (alpha, ref, got)


def test_entry_points_keep_full_fp32():
    """With TF32 asked for process-wide, every entry point still runs at
    full float32 and gives what it gives without, and the caller's
    setting comes back."""
    msa = _msa(seed=6)
    _, t = _engines(msa, _parts(9))
    c, b = _nj_tree(msa)
    base = (t.loglik(c, b), t.site_loglik(c, b), t.optimize_blens(c, b, steps=3))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = (t.loglik(c, b), t.site_loglik(c, b), t.optimize_blens(c, b, steps=3))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert base[0] == tf32[0] and np.array_equal(base[1], tf32[1])
    assert np.array_equal(base[2][0], tf32[2][0]) and base[2][1] == tf32[2][1]


def _report(data):
    """iqtree.iqtree's fields but `seconds`."""
    out = dict(line.split(": ", 1) for line in data.decode().splitlines() if ": " in line)
    out.pop("seconds")
    return out


def _write_parts(path, parts):
    path.write_text("".join(f"{MODEL}, {name} = {a}-{b}\n" for name, a, b in parts))


@pytest.mark.parametrize("flag", ["-p", "-q"])
def test_tree_engine_infer_partitioned_matches_jax(tmp_path, flag):
    msa = _msa(seed=7, n=6, L=150)
    pfile = tmp_path / "combined.fasta.partitions"
    _write_parts(pfile, _parts(3, 150))
    opts = f"-m JTT+F+G {flag} {pfile}"
    jt, jll, ji = jeng.TreeEngine("iqtree").infer(msa, options=opts, n_boot=20, blen_steps=60)
    tt, tll, ti = teng.TreeEngine("iqtree", device="cpu").infer(msa, options=opts, n_boot=20,
                                                                 blen_steps=60)
    assert ti["n_partitions"] == ji["n_partitions"] == 3
    assert ti["n_patterns"] == ji["n_patterns"]
    drop = ("lnL", "seconds")
    assert {k: v for k, v in ti.items() if k not in drop} == \
        {k: v for k, v in ji.items() if k not in drop}
    assert abs(tll - jll) <= BLEN_LL_RTOL * abs(jll), (jll, tll)
    assert_same_tree(jt, tt)


def test_tree_cli_partitioned_matches_jax(port_env):  # noqa: F811
    """`tree -p combined.fasta.partitions` through both CLIs on the skip
    path (a supermatrix and its partition file already in the output
    directory): the same tree and report."""
    msa = _msa(seed=8, n=5, L=160)
    for side in ("jax", "port"):
        out = port_env / side
        out.mkdir()
        write_msa(out / "combined.fasta", msa)
        _write_parts(out / "combined.fasta.partitions", _parts(4, 160))
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        out = port_env / side
        argv = ["tree", "unused_db", "unused_profile", str(out), "--tree-options",
                f"-m JTT+F+G -B 50 -p {out / 'combined.fasta.partitions'}", "-v", "1"]
        assert main(argv) == 0
    ref, got = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(got)
    assert_same_tree(ref["iqtree.treefile"].decode(), got["iqtree.treefile"].decode())
    rep = [_report(x["iqtree.iqtree"]) for x in (ref, got)]
    jll, tll = float(rep[0].pop("lnL")), float(rep[1].pop("lnL"))
    assert abs(tll - jll) <= BLEN_LL_RTOL * abs(jll)
    assert rep[0] == rep[1] and rep[1]["n_partitions"] == "4"
    assert got["tree.chk"] == b"1"


def test_genetree_partitioned_routes_to_infer(port_env, monkeypatch):  # noqa: F811
    """gene-tree with -p: each gene leaves the lockstep batch for `infer`,
    and writes what the JAX package writes: the same topology and report
    fields, lnL within GENE_LL_RTOL and lengths as assert_same_tree, or
    the port's lnL the higher (torch_port_helpers.assert_same_gene_tree's
    rule: on this chain-evolved fixture's near-zero branches the two
    float32 Adam loops may end in two optima of one topology, ROADMAP
    Queue 3).  JTT+F (no +G): the alpha grid would then pick neighbouring
    points; the +G path is held by
    test_tree_engine_infer_partitioned_matches_jax."""
    from unicore_tpu.modules import genetree as jgt
    from unicore_tpu_torch.modules import genetree as tgt

    pfile = port_env / "parts.txt"
    _write_parts(pfile, _parts(2, 80))
    rng = np.random.RandomState(9)
    msas = {g: gene_msa(rng, 5, 80) for g in ("geneA", "geneB")}
    for side in ("jax", "port"):
        for g, msa in msas.items():
            d = port_env / side / "fasta" / g
            d.mkdir(parents=True)
            write_msa(d / f"{g}.fa.filtered", msa)
    calls = []
    real_infer = teng.TreeEngine.infer
    monkeypatch.setattr(teng.TreeEngine, "infer",
                        lambda self, msa, **kw: calls.append(len(msa)) or real_infer(self, msa, **kw))
    for mod, side in ((jgt, "jax"), (tgt, "port")):
        mod.run(SimpleNamespace(
            genetree_input=str(port_env / side), genetree_names="", genetree_tree_builder="iqtree",
            genetree_tree_options=f"-m JTT+F -B 20 -p {pfile}", genetree_realign=False,
            genetree_aligner="foldmason", genetree_aligner_options=None, genetree_threshold=50))
    assert calls == [5, 5]
    ref, got = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(got)
    for name in ref:
        if name.endswith("iqtree.treefile"):
            r, g = (_report(x[name.replace(".treefile", ".iqtree")]) for x in (ref, got))
            jll, tll = float(r.pop("lnL")), float(g.pop("lnL"))
            assert r == g and g["n_partitions"] == "2", name
            jt, tt = (parse_newick(x[name].decode()) for x in (ref, got))
            assert rf_distance(jt, tt) == 0, name
            if abs(tll - jll) <= GENE_LL_RTOL * abs(jll):
                assert_same_tree(jt, tt)
            else:
                assert tll > jll, (name, jll, tll)
        elif not name.endswith(("iqtree.iqtree", "iqtree.log")):
            assert ref[name] == got[name], name
