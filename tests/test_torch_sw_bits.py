"""The port's SW traceback (ops/sw_bits.py, ops/sw_ref.py and the host
traceback of ops/banded.py) against the JAX package's, on the same
integer score windows made from a numpy seed, on the CPU.  The direction
bits, end cells and scores of `sw_forward_bits` must be bit-identical,
and so must every decoded path (the windows of tests/test_sw_bits.py:
random, degenerate and gap-tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from unicore_tpu.ops import banded as jband
from unicore_tpu.ops import sw_bits as jbits
from unicore_tpu.ops import sw_ref as jref
from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.ops import banded as tband
from unicore_tpu_torch.ops import sw_bits as tbits
from unicore_tpu_torch.ops import sw_ref as tref
from unicore_tpu_torch.runtime import profiling

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _random_windows(n=24, seed=0):
    """tests/test_sw_bits.py's windows: integer scores with a planted
    positive diagonal in most, some all-negative."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L1 = rng.randint(3, 90)
        L2 = rng.randint(3, 90)
        S = rng.randint(-60, 25, (L1, L2))
        if rng.rand() < 0.8:
            d = min(L1, L2)
            S[np.arange(d), np.arange(d)] += rng.randint(20, 80, d)
        out.append(S.astype(np.int32))
    return out


def _gap_windows(seed=3):
    """tests/test_sw_bits.py's windows that force E/F states and
    gap-open/extend ties: two diagonal segments offset by a gap."""
    rng = np.random.RandomState(seed)
    windows = []
    for _ in range(12):
        L = rng.randint(10, 50)
        S = np.full((L, L + rng.randint(0, 20)), -10, np.int32)
        d1 = rng.randint(3, 6)
        off = rng.randint(2, 8)
        for i in range(d1):
            S[i, i] = 50
        for i in range(d1, min(L, S.shape[1] - off)):
            S[i, i + off] = 50
        windows.append(S)
    return windows


def _degenerate():
    return [np.zeros((0, 5), np.int32), np.full((4, 4), -50, np.int32),
            np.array([[70]], np.int32), np.zeros((3, 7), np.int32)]


def _padded_batch(windows, Lb):
    """The padded int16 batch sw_traceback_batch builds for one bucket."""
    B = len(windows)
    S = np.full((B, Lb, Lb), tbits.PAD_SCORE, np.int16)
    l1, l2 = np.ones(B, np.int32), np.ones(B, np.int32)
    for b, w in enumerate(windows):
        S[b, :w.shape[0], :w.shape[1]] = w
        l1[b], l2[b] = w.shape
    return S, l1, l2


def _assert_forward_equal(S, l1, l2, go, ge):
    ref = jbits.sw_forward_bits(jnp.asarray(S), jnp.asarray(l1), jnp.asarray(l2), go, ge)
    out = tbits.sw_forward_bits(torch.from_numpy(S), torch.from_numpy(l1),
                                torch.from_numpy(l2), go, ge)
    for name, r, o in zip(("bits", "bi", "bj", "score"), ref, out):
        assert o.dtype == (torch.uint8 if name == "bits" else torch.int32), name
        assert np.array_equal(np.asarray(r), o.numpy()), name


@pytest.mark.parametrize("windows,go,ge", [
    (_random_windows(), 100, 10), (_gap_windows(), 30, 5), (_degenerate()[1:], 100, 10)],
    ids=["random", "gap_ties", "degenerate"])
def test_forward_bits_match_jax(windows, go, ge):
    Lb = tbits._bucket(max(max(w.shape) for w in windows))
    _assert_forward_equal(*_padded_batch(windows, Lb), go, ge)


@pytest.mark.parametrize("Lb,B", [(64, 1), (64, 16), (128, 5)])
def test_forward_bits_match_jax_at_buckets(Lb, B):
    """Buckets 64 and 128, ragged windows down to 1 x 1, random integer
    scores near zero (many ties), both gap pairs."""
    rng = np.random.RandomState(Lb + B)
    S = rng.randint(-40, 30, (B, Lb, Lb)).astype(np.int16)
    l1 = rng.randint(1, Lb + 1, B).astype(np.int32)
    l2 = rng.randint(1, Lb + 1, B).astype(np.int32)
    l1[0] = l2[0] = 1
    for go, ge in ((100, 10), (30, 5)):
        _assert_forward_equal(S, l1, l2, go, ge)


@pytest.mark.parametrize("windows,go,ge", [
    (_random_windows(), 100, 10), (_gap_windows(), 30, 5), (_degenerate(), 100, 10)],
    ids=["random", "gap_ties", "degenerate"])
def test_traceback_batch_matches_jax_and_reference(windows, go, ge):
    profiling.reset_counters()
    ref = jbits.sw_traceback_batch(windows, go, ge)
    out = tbits.sw_traceback_batch(windows, go, ge, device="cpu")
    assert len(out) == len(windows)
    for S, (jq, jt, js), (q, t, s) in zip(windows, ref, out):
        assert np.array_equal(jq, q) and np.array_equal(jt, t) and js == s
        if S.size:
            rs, *_, rq, rt = tref.sw_traceback_ref(S.astype(np.float64), go, ge)
            assert s == rs and np.array_equal(q, rq) and np.array_equal(t, rt)
    assert profiling.get_counters()["traceback.dispatches"] >= 1


def test_traceback_batch_splits_buckets_and_batches():
    """More windows than one batch holds, over two buckets: every batch
    is dispatched, and the results come back in input order."""
    rng = np.random.RandomState(9)
    windows = _random_windows(n=70, seed=4) + [rng.randint(-30, 40, (100, 70)).astype(np.int32)]
    ref = jbits.sw_traceback_batch(windows, 100, 10, batch_size=32)
    out = tbits.sw_traceback_batch(windows, 100, 10, batch_size=32, device="cpu")
    for (jq, jt, js), (q, t, s) in zip(ref, out):
        assert np.array_equal(jq, q) and np.array_equal(jt, t) and js == s


def test_sw_ref_matches_jax():
    rng = np.random.RandomState(12)
    for _ in range(6):
        S = rng.randint(-50, 40, (rng.randint(1, 40), rng.randint(1, 40))).astype(np.float64)
        for go, ge in ((100.0, 10.0), (30.0, 5.0)):
            ref, out = jref.sw_traceback_ref(S, go, ge), tref.sw_traceback_ref(S, go, ge)
            assert ref[:5] == out[:5]
            assert np.array_equal(ref[5], out[5]) and np.array_equal(ref[6], out[6])
            assert jref.sw_forward_ref(S, go, ge) == tref.sw_forward_ref(S, go, ge)


def test_banded_traceback_matches_jax():
    """band_scores_ref and sw_traceback_banded_ref on a homologous pair
    (a planted indel) and on a pair whose band misses, with and without
    the composition-bias correction."""
    rng = np.random.RandomState(13)
    saa, s3d = get_aa_matrix().astype(np.float32), get_3di_matrix().astype(np.float32)
    qa, qs = rng.randint(0, 20, 300), rng.randint(0, 20, 300)
    ta = np.concatenate([rng.randint(0, 20, 12), qa[:150], rng.randint(0, 20, 7), qa[150:]])
    ts = np.concatenate([rng.randint(0, 20, 12), qs[:150], rng.randint(0, 20, 7), qs[150:]])
    qc = rng.randint(-20, 10, 300)
    for d0, W, bias in ((12, 64, None), (15, 128, qc), (-200, 32, None)):
        rs, rJ = jband.band_scores_ref(qa, qs, ta, ts, d0, W, saa, s3d, 4.0, 6.0, qc=bias)
        os_, oJ = tband.band_scores_ref(qa, qs, ta, ts, d0, W, saa, s3d, 4.0, 6.0, qc=bias)
        assert rs.dtype == os_.dtype == np.float64
        assert np.array_equal(rs, os_) and np.array_equal(rJ, oJ)
        ref = jband.sw_traceback_banded_ref(rs, d0, 100.0, 10.0)
        out = tband.sw_traceback_banded_ref(os_, d0, 100.0, 10.0)
        assert ref[0] == out[0]
        assert np.array_equal(ref[1], out[1]) and np.array_equal(ref[2], out[2])
    assert tband.NEG == -1e9
