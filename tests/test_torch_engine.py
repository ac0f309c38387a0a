"""The port's alignment engine (align/engine.py, align/prefilter.py,
align/stats.py) against the JAX package's, on the same sequences made
from a numpy seed: candidate pairs, calibrated lambda/K and every Hit
field must be equal."""

import dataclasses

import numpy as np
import pytest

from torch_port_helpers import port_env, stats_dir  # noqa: F401  (fixture)
from unicore_tpu.align import engine as jeng_mod
from unicore_tpu.align import prefilter as jpre
from unicore_tpu.align import stats as jstats
from unicore_tpu.models.mock import MockProstT5
from unicore_tpu_torch.align import engine as teng_mod
from unicore_tpu_torch.align import prefilter as tpre
from unicore_tpu_torch.align import stats as tstats
from unicore_tpu_torch.convert import from_jax_arrays

LETTERS = "ARNDCQEGHILKMFPSTWYV"


def _families(seed=21, n_fam=4, n_mem=3):
    """Families of mutated copies (with a short indel) plus singletons;
    lengths 60-200 so the buckets 128 and 256 both occur."""
    rng = np.random.RandomState(seed)
    aa = []
    for f in range(n_fam):
        base = rng.choice(list(LETTERS), rng.randint(60, 200))
        for _ in range(n_mem):
            s = base.copy()
            pos = rng.randint(0, len(s), len(s) // 8)
            s[pos] = rng.choice(list(LETTERS), len(pos))
            cut = rng.randint(10, len(s) - 10)
            s = np.delete(s, slice(cut, cut + rng.randint(0, 4)))
            aa.append("".join(s))
    aa += ["".join(rng.choice(list(LETTERS), rng.randint(50, 150))) for _ in range(3)]
    return aa, MockProstT5().predict(aa)


def test_candidate_pairs_match_jax():
    aa, ss = _families()
    kw = dict(min_shared=2, coverage=0.8, sens=5.7, max_seqs=1000)
    ref = jpre.candidate_pairs(aa, ss, **kw)
    out = tpre.candidate_pairs(aa, ss, device="cpu", **kw)
    assert ref == out and len(ref) > 0
    assert np.array_equal(jpre.featurize(aa, ss), tpre.featurize(aa, ss))


def _engines(**overrides):
    jp = jeng_mod.AlignParams(backend="xla", **overrides)
    je = jeng_mod.AlignmentEngine(jp)
    te = teng_mod.AlignmentEngine(**from_jax_arrays(je.saa, je.s3d, je.params), device="cpu")
    return je, te


def test_convert_hands_over_params_and_tables():
    je, te = _engines(gap_window=32, band_width=128)
    for f in dataclasses.fields(teng_mod.AlignParams):
        assert getattr(te.params, f.name) == getattr(je.params, f.name), f.name
    assert np.array_equal(te.saa, je.saa) and np.array_equal(te.s3d, je.s3d)


def _calibrate(engine, key):
    def score_fn(qa, qs, ta, ts, ql, tl):
        return np.asarray(engine._forward_batch(qa, qs, ta, ts, ql, tl)[0])

    mod = tstats if isinstance(engine, teng_mod.AlignmentEngine) else jstats
    return mod.calibrate_gapped_lengths(score_fn, key, lengths=(128, 256), n_samples=(64, 24))


def test_calibration_and_hits_match_jax(port_env):  # noqa: F811
    # fresh fits on both sides: port_env's HOME holds both caches, empty
    # a low long_threshold sends the longer pairs down the banded path
    je, te = _engines(long_threshold=150, band_width=128)
    jgs, tgs = _calibrate(je, "t"), _calibrate(te, "t")
    assert list(jgs.lams) == list(tgs.lams) and list(jgs.Ks) == list(tgs.Ks)
    assert any(stats_dir(port_env, "unicore_tpu").iterdir())
    assert any(stats_dir(port_env, "unicore_tpu_torch").iterdir())

    je._gapped, te._gapped = jgs, tgs
    aa, ss = _families()
    q_aa, q_ss = jeng_mod.encode_db(aa, ss)
    pairs = jpre.candidate_pairs(aa, ss, coverage=0.8)
    # every pair of the first two families too, so unrelated pairs and
    # rescore-pruned pairs are scored as well
    pairs = sorted(set(pairs) | {(i, j) for i in range(6) for j in range(i + 1, 6)})
    assert any(max(len(aa[i]), len(aa[j])) > 150 for i, j in pairs)  # banded
    ref = je.align_pairs(q_aa, q_ss, q_aa, q_ss, pairs)
    out = te.align_pairs(q_aa, q_ss, q_aa, q_ss, pairs)
    assert [dataclasses.asdict(h) for h in ref] == [dataclasses.asdict(h) for h in out]
    assert len(ref) > 0
    qlen = np.array([len(a) for a in q_aa])
    assert ([dataclasses.astuple(h) for h in je.gate(ref, qlen, qlen)]
            == [dataclasses.astuple(h) for h in te.gate(out, qlen, qlen)])


def test_traceback_fill_is_not_yet_ported(port_env):  # noqa: F811
    from unicore_tpu_torch.runtime import errors as err

    te = teng_mod.AlignmentEngine(device="cpu")
    with pytest.raises(err.UnicoreError) as e:
        te.traceback_fill([], [], [], [], [])
    assert e.value.err_code == err.ERR_MODULE_NOT_IMPLEMENTED
