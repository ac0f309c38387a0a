"""The port's cascade (align/cascade.py, cluster_db above its threshold)
against the JAX package's, on the same sequences made from a numpy seed:
canopy representatives and members, the robust null, clust.tsv, and the
representative round's full-database E-values, transitive merge and
empirical null must be equal.

Both E-value calibrations run once for the file, under one HOME of its
own (they take most of its time on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from unicore_tpu.align import cascade as jc
from unicore_tpu.align import prefilter as jpre
from unicore_tpu.align import stats as jstats
from unicore_tpu.align.engine import AlignmentEngine as JEngine
from unicore_tpu.align.engine import AlignParams as JParams
from unicore_tpu.align.engine import Hit as JHit
from unicore_tpu.io.seqdb import SeqDB as JDB
from unicore_tpu_torch.align import cascade as tc
from unicore_tpu_torch.align import prefilter as tpre
from unicore_tpu_torch.align import stats as tstats
from unicore_tpu_torch.align.engine import AlignmentEngine as TEngine
from unicore_tpu_torch.align.engine import AlignParams as TParams
from unicore_tpu_torch.align.engine import Hit as THit
from unicore_tpu_torch.io.seqdb import SeqDB as TDB
from unicore_tpu_torch.runtime import profiling

LETTERS = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(scope="module", autouse=True)
def cascade_env(tmp_path_factory):
    """One HOME (both packages' E-value caches), the CPU, one torch thread."""
    home = tmp_path_factory.mktemp("cascade_home")
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(home))
    mp.setenv("UNICORE_TPU_TORCH_DEVICE", "cpu")
    mp.setenv("UNICORE_TPU_TORCH_ENGINES_CFG", str(home / "port_engines.cfg"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield home
    torch.set_num_threads(threads)
    mp.undo()


def _params():
    return JParams(backend="xla", batch_size=64), TParams(batch_size=64)


def _dbs(names, aa, ss):
    return (JDB(names=list(names), aa_seqs=list(aa), ss_seqs=list(ss)),
            TDB(names=list(names), aa_seqs=list(aa), ss_seqs=list(ss)))


def _canopy_data(seed=3):
    """100 families x 4 members (lengths 80-400, 10% substitutions) and
    200 shorter orphans (30-70): with chunks of 256, length-sorted, the
    first chunk is family members only, the second mixes the last members
    with orphans, and the third (88 sequences) is orphans only."""
    rng = np.random.RandomState(seed)
    aa, ss = [], []
    for _ in range(100):
        L = rng.randint(80, 400)
        base_a, base_s = rng.choice(list(LETTERS), L), rng.choice(list(LETTERS), L)
        for _ in range(4):
            a = base_a.copy()
            for _ in range(L // 10):
                a[rng.randint(L)] = rng.choice(list(LETTERS))
            aa.append("".join(a))
            ss.append("".join(base_s))
    for _ in range(200):
        L = rng.randint(30, 70)
        aa.append("".join(rng.choice(list(LETTERS), L)))
        ss.append("".join(rng.choice(list(LETTERS), L)))
    return aa, ss


def test_canopy_assign_matches_jax(monkeypatch):
    aa, ss = _canopy_data()
    grams = []
    real_gram = tc._gram

    def spy(a, b, dev):
        grams.append((a.shape[0], b.shape[0], a is b))
        out = real_gram(a, b, dev)
        assert out.dtype == np.float32
        return out

    monkeypatch.setattr(tc, "_gram", spy)
    jreps, jmembers = jc.canopy_assign(aa, ss, chunk=256)
    treps, tmembers = tc.canopy_assign(aa, ss, chunk=256)
    assert treps == jreps
    assert tmembers == jmembers
    # chunk 1: the within-chunk gram on the device; chunk 2: the
    # cross-chunk gram, then the within-chunk gram on the device; chunk 3:
    # the cross-chunk gram only, its 88 orphans all unassigned (they all
    # became reps), so its within-chunk gram took the numpy branch
    assert grams == [(256, 256, True), (256, 64, False), (256, 256, True), (88, 212, False)]
    assert len(treps) == 300


@pytest.mark.parametrize("shape", [(40, 70), (600, 500)])  # the second is subsampled
def test_robust_null_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    kb = rng.randint(100, 700, shape[0] + shape[1]).astype(np.float32)
    exp = kb[: shape[0], None].astype(np.float64) * kb[None, shape[0]:] / 2048
    shared = (rng.poisson(1.3 * exp) + (rng.rand(*shape) < 0.01) * 200).astype(np.float32)
    assert tc._robust_null(shared, exp) == jc._robust_null(shared, exp)
    for nrep in (0, 1, 2, 50, 5000):
        assert tc._canopy_threshold(nrep) == jc._canopy_threshold(nrep)


def _jax_test_families():
    """The data of tests/test_align_engine.py::test_cascaded_cluster_small."""
    rng = np.random.RandomState(11)
    tdi = "ACDEFGHIKLMNPQRSTVWY"
    names, aa, ss = [], [], []
    for fam in range(4):
        base_aa = "".join(rng.choice(list(LETTERS), 70))
        base_ss = "".join(rng.choice(list(tdi), 70))
        for k in range(5):
            s = list(base_aa)
            for _ in range(2):
                s[rng.randint(70)] = rng.choice(list(LETTERS))
            names.append(f"f{fam}_m{k}")
            aa.append("".join(s))
            ss.append(base_ss)
    return names, aa, ss


def test_cluster_db_cascade_matches_jax(tmp_path):
    from unicore_tpu.align.clustering import write_cluster_tsv as jwrite
    from unicore_tpu.modules.cluster import cluster_db as jcluster
    from unicore_tpu_torch.align.clustering import write_cluster_tsv as twrite
    from unicore_tpu_torch.modules.cluster import cluster_db as tcluster

    names, aa, ss = _jax_test_families()
    jdb, tdb = _dbs(names, aa, ss)
    jp, tp = _params()
    jclusters, _ = jcluster(jdb, jp, cascade_threshold=10)
    profiling.reset_counters()
    tclusters, _ = tcluster(tdb, tp, cascade_threshold=10)
    jwrite(str(tmp_path / "jax.tsv"), jclusters, names)
    twrite(str(tmp_path / "port.tsv"), tclusters, names)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    assert len(tclusters) == 4  # every family in one cluster, as the JAX test asks
    c = profiling.get_counters()
    assert c["cascade.reps"] >= 4 and c["cascade.verify_pairs"] > 0
    assert 0 < c["cascade.verified"] <= c["cascade.verify_pairs"]
    assert c["cascade.empirical_null_fitted"] == 0  # fewer than 5,000 rep-round pairs
    assert c["cluster.clusters"] == 4


def test_rep_round_evalues_use_full_database(monkeypatch):
    rng = np.random.RandomState(5)
    aa = ["".join(rng.choice(list(LETTERS), 60)) for _ in range(12)]
    ss = ["".join(rng.choice(list(LETTERS), 60)) for _ in range(12)]
    dbs = _dbs([f"s{i}" for i in range(12)], aa, ss)
    reps = [0, 3, 7]
    verified = {0: [1, 2], 3: [4, 5, 6], 7: [8, 9, 10, 11]}

    seen, finals = {}, []
    for name, engine_cls in (("jax", JEngine), ("port", TEngine)):
        orig = engine_cls.align_pairs

        def spy(self, q_aa, q_ss, t_aa, t_ss, pairs, n_db=None, n_seqs=None, _o=orig, _n=name, **kw):
            seen[_n] = (n_db, n_seqs)
            return _o(self, q_aa, q_ss, t_aa, t_ss, pairs, n_db=n_db, n_seqs=n_seqs, **kw)

        monkeypatch.setattr(engine_cls, "align_pairs", spy)
    for mod, db, params in zip((jc, tc), dbs, _params()):
        finals.append(mod.representative_round(db, list(reps), verified, params)[0])
    assert seen["port"] == seen["jax"] == (float(sum(len(s) for s in aa)), 12)
    assert finals[1] == finals[0]


def test_rep_round_transitive_merge(monkeypatch):
    rng = np.random.RandomState(9)
    aa = ["".join(rng.choice(list(LETTERS), 60)) for _ in range(6)]
    dbs = _dbs([f"s{i}" for i in range(6)], aa, aa)
    verified = {0: [1], 2: [3], 4: [5]}
    for engine_cls, hit_cls in ((JEngine, JHit), (TEngine, THit)):
        def fake_align(self, q_aa, q_ss, t_aa, t_ss, pairs, _h=hit_cls, **kw):
            return [_h(qidx=qi, tidx=ti, score=2000.0, qstart=0, qend=59, tstart=0, tend=59,
                       evalue=1e-30, bits=100.0) for qi, ti in [(0, 1), (1, 2)]]  # chain 0-1-2
        monkeypatch.setattr(engine_cls, "align_pairs", fake_align)
    finals = [mod.representative_round(db, [0, 2, 4], verified, params)[0]
              for mod, db, params in zip((jc, tc), dbs, _params())]
    assert finals[1] == finals[0] == {0: [0, 1, 2, 3, 4, 5]}


def test_rep_round_fits_the_empirical_null(monkeypatch):
    """101 representatives (10 families of 3 mutated copies, 71 unrelated
    sequences, lengths 40-120), every pair a candidate: 5,050 rep-round
    pairs, so both packages fit the empirical null and gate on it."""
    rng = np.random.RandomState(17)
    aa, ss = [], []
    for _ in range(10):
        L = rng.randint(40, 120)
        base_a, base_s = rng.choice(list(LETTERS), L), rng.choice(list(LETTERS), L)
        for _ in range(3):
            a = base_a.copy()
            a[rng.randint(0, L, L // 12)] = rng.choice(list(LETTERS), L // 12)
            aa.append("".join(a))
            ss.append("".join(base_s))
    for L in rng.randint(40, 120, 71):
        aa.append("".join(rng.choice(list(LETTERS), L)))
        ss.append("".join(rng.choice(list(LETTERS), L)))
    n = len(aa)
    dbs = _dbs([f"s{i}" for i in range(n)], aa, ss)

    def every_pair(aa_seqs, ss_seqs, **kw):
        return [(i, j) for i in range(len(aa_seqs)) for j in range(i + 1, len(aa_seqs))]

    fitted = {}
    for name, pre, st in (("jax", jpre, jstats), ("port", tpre, tstats)):
        monkeypatch.setattr(pre, "candidate_pairs", every_pair)
        real_fit = st.fit_empirical_pair_null

        def spy(scores, *a, _f=real_fit, _n=name, **kw):
            out = _f(scores, *a, **kw)
            fitted[_n] = (len(scores), out is not None)
            return out

        monkeypatch.setattr(st, "fit_empirical_pair_null", spy)
    profiling.reset_counters()
    out = [mod.representative_round(db, list(range(n)), {r: [] for r in range(n)}, params)
           for mod, db, params in zip((jc, tc), dbs, _params())]
    assert fitted["port"] == fitted["jax"] == (n * (n - 1) // 2, True)
    (jfinal, jkept), (tfinal, tkept) = out
    assert tfinal == jfinal
    assert [dataclasses.astuple(h) for h in tkept] == [dataclasses.astuple(h) for h in jkept]
    assert len(tkept) > 0 and len(tfinal) < n  # families merged through gated edges
    c = profiling.get_counters()
    assert c["cascade.empirical_null_fitted"] == 1
    assert (c["cascade.rep_pairs"], c["cascade.rep_edges"]) == (n * (n - 1) // 2, len(tkept))
