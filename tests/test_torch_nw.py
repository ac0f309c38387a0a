"""The port's device NW (unicore_tpu_torch/ops/nw_device.py) against the JAX
package's (unicore_tpu/ops/nw_device.py), on the CPU.

Every merge is integer arithmetic, so the tolerance is none: bits, end
cells, scores and paths must be identical, ties included.  Inputs come
from numpy seeds and reach both packages as numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import port_env  # noqa: F401  (fixture)
from unicore_tpu.alphabets import AA_SIZE, TDI_SIZE
from unicore_tpu.msa import progressive as jprog
from unicore_tpu.ops import nw as jnw
from unicore_tpu.ops import nw_device as J
from unicore_tpu_torch.msa import progressive as tprog
from unicore_tpu_torch.ops import nw as tnw
from unicore_tpu_torch.ops import nw_device as T
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.synthetic import NW_SCORE_KINDS, PAD_SCORE, nw_scores

GAPS = [(11 * 256, 256), (1100, 100)]  # the engines' defaults in QUANT units; another pair


@pytest.mark.parametrize("B,L1,L2", [(6, 64, 64), (5, 40, 97), (4, 128, 33), (1, 1, 1), (3, 2, 70)])
@pytest.mark.parametrize("kind", NW_SCORE_KINDS)
@pytest.mark.parametrize("gaps", GAPS)
def test_nw_forward_bits_matches_jax(B, L1, L2, kind, gaps):
    rng = np.random.RandomState(B * 1000 + L1 + L2)
    S, l1, l2 = nw_scores(rng, B, L1, L2, kind)
    go, ge = gaps
    ref = [np.asarray(x) for x in J.nw_forward_bits(jnp.asarray(S), jnp.asarray(l1),
                                                     jnp.asarray(l2), go, ge)]
    got = [x.numpy() for x in T.nw_forward_bits(torch.from_numpy(S), torch.from_numpy(l1),
                                                torch.from_numpy(l2), go, ge)]
    for name, r, g in zip(("bits", "end_i", "end_j", "score"), ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert np.array_equal(r, g), name


def test_pad_score_equal():
    assert T.PAD_SCORE == J.PAD_SCORE == PAD_SCORE and T.INT_NEG == J.INT_NEG


def test_decode_path_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(40):
        L1, L2 = rng.randint(1, 60, 2)
        bits = rng.randint(0, 16, (L1, L2)).astype(np.uint8)
        ei, ej = int(rng.randint(0, L1 + 1)), int(rng.randint(0, L2 + 1))
        assert T.decode_path(bits, ei, ej, L1, L2) == J.decode_path(bits, ei, ej, L1, L2)


def _random_score(rng, L1, L2):
    S = rng.randn(L1, L2).astype(np.float64) * 2.0 - 1.0
    w = min(L1, L2)
    S[np.arange(w), np.arange(w)] += 6.0
    return jnw.quantize_scores(S)


@pytest.mark.parametrize("gaps", GAPS)
def test_nw_align_batch_matches_jax_and_host(gaps):
    """Ragged batches in four buckets, the degenerate empty shapes, a
    tie-heavy matrix; the host reference nw_align is the plain version."""
    rng = np.random.RandomState(42)
    cases = [(12, 17), (1, 9), (9, 1), (64, 64), (33, 70), (128, 40), (200, 3), (5, 300)]
    S_list = [_random_score(rng, a, b) for a, b in cases]
    S_list += [tnw.quantize_scores(np.full((5, 5), -3.0)), np.zeros((7, 9), np.int32),
               np.zeros((0, 4), np.int32), np.zeros((6, 0), np.int32)]
    go, ge = gaps
    ref = J.nw_align_batch(S_list, go, ge)
    got = T.nw_align_batch(S_list, go, ge, device="cpu")
    assert got == ref
    for S, (path, score) in zip(S_list, got):
        assert (path, score) == tnw.nw_align(S, go=go, ge=ge)


def _count_entries(rng, eng, n_merges, max_n):
    entries = []
    Lseq = 160
    for _ in range(n_merges):
        n1, n2 = rng.randint(1, max_n + 1, 2)
        L1, L2 = rng.randint(3, 120, 2)
        aa_codes = [rng.randint(0, 21, Lseq) for _ in range(n1 + n2)]
        ss_codes = [rng.randint(0, 21, Lseq) for _ in aa_codes]

        def rand_aln(rows, L):
            cols = np.sort(rng.choice(Lseq, L, replace=False))
            return jprog._Alignment(rows, np.broadcast_to(cols, (len(rows), L)).astype(np.int32).copy())

        a1 = rand_aln(list(range(n1)), L1)
        a2 = rand_aln(list(range(n1, n1 + n2)), L2)
        entries.append((
            jprog._count_profile(a1, aa_codes, AA_SIZE), jprog._count_profile(a1, ss_codes, TDI_SIZE),
            jprog._count_profile(a2, aa_codes, AA_SIZE), jprog._count_profile(a2, ss_codes, TDI_SIZE),
            int(n1), int(n2),
        ))
    return entries


@pytest.mark.parametrize("w", [(1.4, 2.1), (4.0, 6.0), (1.0, 0.0)])
def test_nw_align_batch_counts_matches_jax(w):
    """The fused count path (float64 products, int64 floor quantization)
    against the JAX one (float32 HIGHEST products, int32) at the default
    weights, at kernel-unit weights 40/60 and AA-only, with the largest
    n1*n2 the exact bound lets through."""
    rng = np.random.RandomState(4)
    jeng = jprog.ProgressiveMSA(mode="3di+aa", w_aa=w[0], w_3di=w[1])
    entries = _count_entries(rng, jeng, 16, 9)
    bound = J.nw_counts_exact_bound(jeng.saa, jeng.s3d, jeng._wA, jeng._wS)
    n = int(np.sqrt(bound))
    big = _count_entries(rng, jeng, 1, 1)[0]
    entries.append((big[0] * n, big[1] * n, big[2] * n, big[3] * n, n, n))  # n1*n2 at the bound
    entries.append((np.zeros((0, 21), np.int64), None, big[2], None, 1, 1))  # empty profile
    args = (jeng.go_q, jeng.ge_q, jeng.saa, jeng.s3d, jeng._wA, jeng._wS)
    ref = J.nw_align_batch_counts(entries, *args)
    got = T.nw_align_batch_counts(entries, *args, device="cpu")
    assert got == ref


@pytest.mark.parametrize("w", [(1.4, 2.1), (4.0, 6.0), (1.0, 0.0), (0.0, 3.0)])
def test_nw_counts_exact_bound_equal(w):
    jeng = jprog.ProgressiveMSA(mode="3di+aa", w_aa=w[0], w_3di=w[1])
    assert T.nw_counts_exact_bound(jeng.saa, jeng.s3d, jeng._wA, jeng._wS) == \
        J.nw_counts_exact_bound(jeng.saa, jeng.s3d, jeng._wA, jeng._wS)


def test_host_route_at_kernel_unit_weights_matches_jax(port_env):  # noqa: F811
    """Weights 40/60 shrink the exact bound to 5,745: a gene of two
    80-sequence subfamilies puts its root merge (80 x 80) on the
    host-scored route, in both packages, with identical MSAs."""
    rng = np.random.RandomState(8)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    seqs = []
    for _ in range(2):
        base = rng.choice(letters, 30)
        for _ in range(80):
            s = base.copy()
            s[rng.randint(30, size=3)] = rng.choice(letters, 3)
            seqs.append("".join(s))
    names = [f"s{i}" for i in range(len(seqs))]
    ss = ["".join(rng.choice(letters, len(s))) for s in seqs]
    jeng = jprog.ProgressiveMSA(mode="3di+aa", w_aa=4.0, w_3di=6.0)
    teng = tprog.ProgressiveMSA(mode="3di+aa", w_aa=4.0, w_3di=6.0)
    assert T.nw_counts_exact_bound(teng.saa, teng.s3d, teng._wA, teng._wS) == 5745
    profiling.reset_counters()
    got = teng.align_many([(names, seqs, ss)])
    assert profiling.get_counters()["msa.host_route_merges"] >= 1
    assert got == jeng.align_many([(names, seqs, ss)])
