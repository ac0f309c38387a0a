"""The port's banded SW and seed helpers (ops/banded.py) against the JAX
package's, on the same inputs made from a numpy seed; bit-identical."""

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch
from unicore_tpu.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu.ops import banded as jb
from unicore_tpu_torch.ops import banded as tb

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)


def _planted_pair(rng, L, shift, nmut, indels=3, sub_3di=False):
    """Target = shifted, mutated copy of the query with small indels."""
    qa = rng.randint(0, 20, L).astype(np.int32)
    qs = rng.randint(0, 20, L).astype(np.int32)
    ta = np.concatenate([rng.randint(0, 20, shift), qa.copy()]).astype(np.int32)
    ts = np.concatenate([rng.randint(0, 20, shift), qs.copy()]).astype(np.int32)
    pos = rng.randint(shift, shift + L, nmut)
    ta[pos] = rng.randint(0, 20, nmut)
    if sub_3di:
        ts[pos] = rng.randint(0, 20, nmut)
    for _ in range(indels):
        cut = rng.randint(shift + 10, len(ta) - 10)
        if rng.rand() < 0.5:
            ta = np.delete(ta, slice(cut, cut + 2))
            ts = np.delete(ts, slice(cut, cut + 2))
        else:
            ta = np.insert(ta, cut, rng.randint(0, 20, 2))
            ts = np.insert(ts, cut, rng.randint(0, 20, 2))
    return qa, qs, ta, ts


def _seed_cases():
    rng = np.random.RandomState(11)
    cases = [_planted_pair(rng, 300, s, n, sub_3di=sub)
             for s, n, sub in ((0, 20, False), (40, 60, False), (130, 150, True), (7, 290, True))]
    junk = tuple(rng.randint(0, 20, 250).astype(np.int32) for _ in range(4))
    return cases + [junk]


def test_seed_helpers_match_jax():
    for qa, qs, ta, ts in _seed_cases():
        assert np.array_equal(jb._combined_kmers(qa, qs), tb._combined_kmers(qa, qs))
        assert np.array_equal(jb._plain_kmers(qs, 21, 6), tb._plain_kmers(qs, 21, 6))
        assert jb.vote_diagonal(qa, qs, ta, ts) == tb.vote_diagonal(qa, qs, ta, ts)
        assert (jb.vote_diagonal_sensitive(qa, qs, ta, ts)
                == tb.vote_diagonal_sensitive(qa, qs, ta, ts))
        assert jb.has_seed_evidence(qa, qs, ta, ts) == tb.has_seed_evidence(qa, qs, ta, ts)
        qk, tk = jb._combined_kmers(qa, qs), jb._combined_kmers(ta, ts)
        assert (jb._vote_hist(qk, tk, len(qa), len(ta), 16, 8)
                == tb._vote_hist(qk, tk, len(qa), len(ta), 16, 8))
        assert (jb._channel_match_excess(qk, tk, 441.0 ** 6)
                == tb._channel_match_excess(qk, tk, 441.0 ** 6))
    assert np.array_equal(jb.REDUCED_AA_GROUPS, tb.REDUCED_AA_GROUPS)


def _band_batch(seed, B, LQ, LT, bias):
    rng = np.random.RandomState(seed)
    qa = np.full((B, LQ), 20, np.int32)
    qs, ta, ts = qa.copy(), np.full((B, LT), 20, np.int32), np.full((B, LT), 20, np.int32)
    ql, tl, d0 = np.ones(B, np.int32), np.ones(B, np.int32), np.zeros(B, np.int32)
    qc = np.zeros((B, LQ), np.int32) if bias else None
    for b in range(B):
        L = rng.randint(LQ // 2, LQ - 64)
        pa, ps, pta, pts = _planted_pair(rng, L, rng.randint(0, 40), L // 8)
        pta, pts = pta[:LT], pts[:LT]
        ql[b], tl[b] = len(pa), len(pta)
        qa[b, :ql[b]], qs[b, :ql[b]], ta[b, :tl[b]], ts[b, :tl[b]] = pa, ps, pta, pts
        d0[b] = tb.vote_diagonal(pa, ps, pta, pts) or 0
        if bias:
            qc[b, :ql[b]] = rng.randint(-60, 40, ql[b])
    return qa, qs, ta, ts, ql, tl, d0, qc


@pytest.mark.parametrize("mode", ["w0", "w64", "ungapped"])
@pytest.mark.parametrize("bias", [False, True])
def test_sw_forward_banded_matches_jax(mode, bias):
    import jax.numpy as jnp

    qa, qs, ta, ts, ql, tl, d0, qc = _band_batch(3, 4, 256, 256, bias)
    kw = dict(W=128, go=100.0, ge=10.0, w_aa=4.0, w_3di=6.0,
              gap_window=64 if mode == "w64" else 0, ungapped=mode == "ungapped")
    ref = jb.sw_forward_banded(
        *(jnp.asarray(x) for x in (qa, qs, ta, ts, ql, tl, d0, SAA, S3D)),
        qc=None if qc is None else jnp.asarray(qc), **kw)
    t = as_torch(qa, qs, ta, ts, ql, tl, d0, SAA, S3D, qc)
    out = tb.sw_forward_banded(*t[:9], qc=t[9], **kw)
    for r, o in zip(ref, out):
        r = np.asarray(r)
        assert r.dtype == o.numpy().dtype
        assert np.array_equal(r, o.numpy()), (r, o)
    assert float(out[0].max()) > 0
