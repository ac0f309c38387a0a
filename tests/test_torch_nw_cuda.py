"""The MSA's device work on the card against the same functions on the CPU:
the NW forward, the fused count-profile merge, the guide-tree gram and
the progressive MSA in its three modes, bit-identical, with TF32 matmuls
allowed (`torch.set_float32_matmul_precision("high")`).

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nw_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import need_cuda
from unicore_tpu_torch.alphabets import AA_SIZE, TDI_SIZE
from unicore_tpu_torch.msa import guide_tree, progressive
from unicore_tpu_torch.ops import nw_device
from unicore_tpu_torch.synthetic import NW_SCORE_KINDS, nw_scores

GAPS = [(11 * 256, 256), (1100, 100)]


@pytest.fixture
def tf32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("Lb,B", [(64, 1), (64, 64), (512, 1), (512, 64), (2048, 1), (2048, 16)])
@pytest.mark.parametrize("gaps", GAPS)
def test_nw_forward_bits_cuda_equals_cpu(Lb, B, gaps):
    need_cuda()
    for n, kind in enumerate(NW_SCORE_KINDS):
        rng = np.random.RandomState(Lb + B + n)
        S, l1, l2 = nw_scores(rng, B, Lb, Lb - 7 * n, kind)
        t = [torch.from_numpy(x) for x in (S, l1, l2)]
        cpu = nw_device.nw_forward_bits(*t, *gaps)
        gpu = nw_device.nw_forward_bits(*(x.cuda() for x in t), *gaps)
        for name, a, b in zip(("bits", "end_i", "end_j", "score"), cpu, gpu):
            assert b.is_cuda and torch.equal(a, b.cpu()), (name, kind)


def _entries(rng, n_merges, max_n, L_max):
    entries = []
    for _ in range(n_merges):
        n1, n2 = rng.randint(1, max_n + 1, 2)
        L1, L2 = rng.randint(3, L_max, 2)
        Lseq = L_max + 50
        aa = [rng.randint(0, 21, Lseq) for _ in range(n1 + n2)]
        ss = [rng.randint(0, 21, Lseq) for _ in aa]

        def aln(rows, L):
            cols = np.sort(rng.choice(Lseq, L, replace=False))
            return progressive._Alignment(rows, np.broadcast_to(cols, (len(rows), L)).astype(np.int32).copy())

        a1, a2 = aln(list(range(n1)), L1), aln(list(range(n1, n1 + n2)), L2)
        entries.append((progressive._count_profile(a1, aa, AA_SIZE), progressive._count_profile(a1, ss, TDI_SIZE),
                        progressive._count_profile(a2, aa, AA_SIZE), progressive._count_profile(a2, ss, TDI_SIZE),
                        int(n1), int(n2)))
    return entries


@pytest.mark.cuda
@pytest.mark.parametrize("w", [(1.4, 2.1), (4.0, 6.0)])
def test_counts_path_cuda_equals_cpu_under_tf32(tf32, w):
    """Buckets 64 to 2,048 and n1*n2 at the exact bound, where float32
    products under TF32 would round."""
    need_cuda()
    rng = np.random.RandomState(5)
    eng = progressive.ProgressiveMSA(mode="3di+aa", w_aa=w[0], w_3di=w[1], device="cpu")
    entries = _entries(rng, 12, 12, 120) + _entries(rng, 4, 4, 2000)
    n = int(np.sqrt(nw_device.nw_counts_exact_bound(eng.saa, eng.s3d, eng._wA, eng._wS)))
    e = _entries(rng, 1, 1, 600)[0]
    entries.append((e[0] * n, e[1] * n, e[2] * n, e[3] * n, n, n))
    args = (eng.go_q, eng.ge_q, eng.saa, eng.s3d, eng._wA, eng._wS)
    assert nw_device.nw_align_batch_counts(entries, *args, device="cuda") == \
        nw_device.nw_align_batch_counts(entries, *args, device="cpu")


@pytest.mark.cuda
def test_guide_gram_exact_on_cuda_under_tf32(tf32):
    need_cuda()
    rng = np.random.RandomState(1)
    feats = (rng.rand(2000, 8192) < 0.45).astype(np.int8)
    f64 = feats.astype(np.float64)
    ref = f64 @ f64.T  # exact: every count < 2^53
    got = guide_tree._shared_counts(feats, "cuda")
    assert np.array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,refine", [("3di+aa", 0), ("aa", 0), ("aa", 2)])
def test_align_many_cuda_equals_cpu(tf32, mode, refine):
    need_cuda()
    rng = np.random.RandomState(7)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    genes = []
    for g, (n, L) in enumerate(((20, 80), (12, 300), (4, 1100), (3, 40), (2, 10), (1, 5), (0, 0))):
        base = rng.choice(letters, max(L, 1))
        seqs = []
        for _ in range(n):
            s = base.copy()
            s[rng.rand(len(s)) < 0.2] = rng.choice(letters)
            cut = rng.randint(0, len(s))
            seqs.append("".join(np.delete(s, slice(cut, cut + 3))))
        ss = ["".join(rng.choice(letters, len(s))) for s in seqs] if mode == "3di+aa" else None
        genes.append(([f"g{g}s{i}" for i in range(n)], seqs, ss))
    cpu = progressive.ProgressiveMSA(mode=mode, refine_iters=refine, device="cpu").align_many(genes)
    gpu = progressive.ProgressiveMSA(mode=mode, refine_iters=refine, device="cuda").align_many(genes)
    assert gpu == cpu
