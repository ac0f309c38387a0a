"""The port's MSA (unicore_tpu_torch/msa) against the JAX package's
(unicore_tpu/msa), on the CPU: guide-tree distances and topology, the
progressive MSA in its three modes (foldmason, mafft, mafft-linsi), the
gap filter and the supermatrix.  Integer merges: results must be
identical, byte for byte."""

import numpy as np
import pytest
import torch

from torch_port_helpers import port_env  # noqa: F401  (fixture)
from unicore_tpu.msa import concat as jconcat
from unicore_tpu.msa import gapfilter as jgap
from unicore_tpu.msa import guide_tree as jgt
from unicore_tpu.msa import progressive as jprog
from unicore_tpu_torch.msa import concat as tconcat
from unicore_tpu_torch.msa import gapfilter as tgap
from unicore_tpu_torch.msa import guide_tree as tgt
from unicore_tpu_torch.msa import progressive as tprog
from unicore_tpu_torch.runtime import profiling

LETTERS = list("ARNDCQEGHILKMFPSTWYV")
MODES = {"foldmason": dict(mode="3di+aa"), "mafft": dict(mode="aa"),
         "mafft-linsi": dict(mode="aa", refine_iters=2)}


def _fam(rng, n, L, mut=0.15):
    base = rng.choice(LETTERS, L)
    out = []
    for _ in range(n):
        s = base.copy()
        s[rng.rand(L) < mut] = rng.choice(LETTERS)
        if rng.rand() < 0.5:  # an indel
            cut = rng.randint(1, L - 3)
            s = np.delete(s, slice(cut, cut + 2))
        out.append("".join(s))
    return out


def _genes():
    """The inputs of tests/test_msa.py and tests/test_nw_device.py, genes
    across the 64-256 buckets, and the degenerate genes: no sequence, one,
    two, and empty sequences."""
    rng = np.random.RandomState(5)
    seq_sets = [
        ["ACDEFG", "ACDEFG", "ACDEFG"],
        ["MKVLITGGGSGIGL", "MKVLITGGSGIGL", "MKVLITGGGSGIGL"],
        ["ACDEFGHIKL", "ACDEFGHIKL"],
        ["MKVLITGGGSGIGLAIAKE" * 3, "MKVLITGGGSGIGLAIAKR" * 3, "WWPPYYQQNNRRSSTTVVX" * 3],
    ]
    for g in range(3):  # test_nw_device.py::test_align_many_equals_sequential_align
        base = "".join(rng.choice(LETTERS, 40 + 10 * g))
        seqs = []
        for m in range(4 + g):
            s = list(base)
            for _ in range(3):
                s[rng.randint(len(base))] = rng.choice(LETTERS)
            if m % 2:
                del s[rng.randint(len(s))]
            seqs.append("".join(s))
        seq_sets.append(seqs)
    for n, L in ((4, 60), (5, 45), (3, 70), (9, 150), (6, 230), (12, 90)):
        seq_sets.append(_fam(rng, n, L))
    seq_sets += [[], ["MKV"], ["MKVLAT", "MKVAT"], ["", "ACDEF", "ACDEFG", ""], ["", ""]]
    genes = []
    for g, seqs in enumerate(seq_sets):
        names = [f"g{g}s{i}" for i in range(len(seqs))]
        ss = ["".join(rng.choice(LETTERS, len(s))) for s in seqs]
        genes.append((names, seqs, ss))
    return genes


def test_kmer_distances_and_guide_topology_match_jax():
    genes = _genes()
    seqs = [g[1] for g in genes if len(g[1]) > 1]
    ref = jgt.kmer_distance_matrices(seqs)
    got = tgt.kmer_distance_matrices(seqs, device="cpu")
    assert len(ref) == len(got)

    def shape(node):
        return node.idx if node.is_leaf else (shape(node.left), shape(node.right), node.height)

    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
        assert shape(jgt.upgma(r)) == shape(tgt.upgma(g))
    assert np.array_equal(jgt.kmer_distance_matrix(seqs[3]),
                          tgt.kmer_distance_matrix(seqs[3], device="cpu"))


def test_guide_gram_exact_under_tf32_setting():
    """The 0/1 gram stays exact with TF32 matmuls allowed (on the CPU the
    setting changes nothing; tests/test_torch_nw_cuda.py checks the card)."""
    rng = np.random.RandomState(1)
    feats = (rng.rand(300, 8192) < 0.4).astype(np.int8)
    ref = feats.astype(np.int64) @ feats.T.astype(np.int64)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = tgt._shared_counts(feats, "cpu")
    finally:
        torch.set_float32_matmul_precision(prev)
    assert got.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("mode", list(MODES))
def test_align_many_matches_jax(port_env, mode):  # noqa: F811
    genes = _genes()
    if MODES[mode]["mode"] == "aa":
        genes = [(n, s, None) for n, s, _ in genes]
    jeng = jprog.ProgressiveMSA(**MODES[mode])
    teng = tprog.ProgressiveMSA(**MODES[mode])
    assert teng.device == torch.device("cpu")
    profiling.reset_counters()
    got = teng.align_many(genes)
    assert got == jeng.align_many(genes)
    counters = profiling.get_counters()
    assert counters["msa.dispatches"] > 0 and counters["msa.cells"] > 0
    assert "msa.host_route_merges" not in counters
    # one gene alone gives what it gives inside the batch
    for g in (1, 7, len(genes) - 2):
        assert teng.align(*genes[g]) == got[g]


def test_batched_refinement_equals_host_refine(port_env):  # noqa: F811
    """The port's batched linsi refinement against its own sequential
    host reference `_refine` (tests/test_msa.py holds the JAX pair)."""
    genes = [g for g in _genes() if len(g[1]) >= 3][:6]
    eng = tprog.ProgressiveMSA(mode="aa", refine_iters=2)
    eng0 = tprog.ProgressiveMSA(mode="aa")
    batched = eng.align_many([(n, s, None) for n, s, _ in genes])
    for (names, seqs, _), got in zip(genes, batched):
        base = eng0.align(names, seqs)
        cols = []
        for nm in names:
            a = np.frombuffer(base[nm].encode(), np.uint8) != ord("-")
            cols.append(np.where(a, np.cumsum(a) - 1, -1).astype(np.int32))
        aln = tprog._Alignment(list(range(len(names))), np.stack(cols))
        aa_codes = [tprog.encode_aa(s).astype(np.int32) for s in seqs]
        for _ in range(2):
            aln = eng0._refine(aln, aa_codes, None)
        assert eng0._emit(aln, names, seqs) == got


@pytest.mark.parametrize("mode", list(MODES))
def test_integer_units_equal(port_env, mode):  # noqa: F811
    jeng = jprog.ProgressiveMSA(**MODES[mode])
    teng = tprog.ProgressiveMSA(**MODES[mode])
    for unit in ("go_q", "ge_q", "_wA", "_wS"):
        assert getattr(teng, unit) == getattr(jeng, unit), unit
    assert np.array_equal(teng.saa, jeng.saa) and np.array_equal(teng.s3d, jeng.s3d)


def test_filter_and_combine_bytes_match_jax(tmp_path):
    """Three gene MSAs over overlapping species: the filtered MSAs at four
    thresholds, combined.fasta and its partitions, byte for byte."""
    rng = np.random.RandomState(2)
    genes = []
    for species, L in ((["sp1", "sp2", "sp3"], 12), (["sp2", "sp4"], 7),
                       (["sp3", "sp1", "sp4", "sp2"], 20)):
        rows = rng.choice(LETTERS + ["-"] * 8, (len(species), L))
        genes.append("".join(f">{s}\n{''.join(r)}\n" for s, r in zip(species, rows)))
    files = {}
    for pkg, gap, concat in (("jax", jgap, jconcat), ("port", tgap, tconcat)):
        root = tmp_path / pkg
        paths = []
        for g, text in enumerate(genes):
            d = root / "fasta" / f"gene{g}"
            d.mkdir(parents=True)
            (d / f"gene{g}.fa").write_text(text)
            for t in (0, 34, 67, 100):
                gap.filter_msa(str(d / f"gene{g}.fa"), str(d / f"gene{g}.fa.t{t}"), t)
            gap.filter_msa(str(d / f"gene{g}.fa"), str(d / f"gene{g}.fa.filtered"), 50)
            paths.append(str(d / f"gene{g}.fa.filtered"))
        concat.combine_fasta(paths, str(root))
        files[pkg] = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert len(files["jax"]) == 3 * 6 + 2
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("threshold", [0, 50, 67, 100])
def test_filter_columns_matches_jax(threshold):
    rng = np.random.RandomState(threshold)
    msa = {f"s{i}": "".join(rng.choice(LETTERS[:4] + ["-"] * 3, 40)) for i in range(7)}
    assert tgap.filter_columns(msa, threshold) == jgap.filter_columns(msa, threshold)
