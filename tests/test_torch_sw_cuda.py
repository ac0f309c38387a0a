"""The SW kernel (csrc/sw.cu) against its plain version, and the
prefilter's gram product against the CPU's, on the card.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sw_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch, need_cuda, random_pairs
from unicore_tpu_torch.align import prefilter
from unicore_tpu_torch.align.bias import bias_clip_bound
from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.models.mock import MockProstT5
from unicore_tpu_torch.ops import sw as tsw
from unicore_tpu_torch.ops import sw_cuda
from unicore_tpu_torch.synthetic import SW_EDGE_CASES, sw_edge_pairs

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
MODES = {"w0": dict(gap_window=0), "w64": dict(gap_window=64), "ungapped": dict(ungapped=True)}


def _inputs(seed, bias, B, L):
    rng = np.random.RandomState(seed)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, B, L, L, plant=min(L, 300))
    if bias == "off":
        qc = None
    elif bias == "on":
        qc = rng.randint(-150, 40, qa.shape).astype(np.int32)
    else:  # exactly +-bias_clip_bound, the largest |qc| composition_bias emits
        bound = int(bias_clip_bound(SAA, S3D, 4.0, 6.0))
        qc = rng.choice([-bound, bound], size=qa.shape).astype(np.int32)
    dev = torch.device("cuda")
    return [None if x is None else x.to(dev) for x in as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D, qc)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bias", ["off", "on", "clip"])
@pytest.mark.parametrize("go,ge", [(100.0, 10.0), (28.0, 3.0)])
def test_kernel_matches_plain_on_cuda(mode, bias, go, ge):
    need_cuda()
    kind = "ungapped" if mode == "ungapped" else "gapped"
    for B, L in ((64, 128), (16, 512), (4, 2048), (8, 200)):
        t = _inputs(9, bias, B, L)
        before = sw_cuda.LAUNCHES[kind]
        k = sw_cuda.sw_forward_cuda(*t[:8], go=go, ge=ge, qc=t[8], **MODES[mode])
        torch.cuda.synchronize()
        assert sw_cuda.LAUNCHES[kind] == before + 1
        p = tsw.sw_forward_plain(*t[:8], go=go, ge=ge, qc=t[8], **MODES[mode])
        for a, b in zip(k, p):
            assert torch.equal(a, b), (B, L)


# Target widths at the edges of the kernel's mapping: one lane, a warp of
# 32*C columns and one column past it, 2 to 8 warps per pair, and every C
# the kernel picks (gapped: 4 up to 128, 8 up to 256, 16 above; ungapped:
# 4 up to 256, 8 up to 2,048, 16 above).  Lq differs from Lt in every case.
EDGE_LT = [1, 31, 32, 33, 63, 64, 65, 128, 129, 200, 256, 257, 511, 512, 513,
           1024, 1025, 2048, 4096]
EDGE_WINDOWS = [0, 1, 2, 3, 48, 64, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("Lt", EDGE_LT)
def test_kernel_matches_plain_at_mapping_edges(Lt):
    """Bit-exact on every case of synthetic.sw_edge_pairs, with B of 1, 5
    or 13, every window the scan treats differently (inside a lane, across
    lanes, across warps, Lt and 2*Lt) and the ungapped mode."""
    need_cuda()
    B = (1, 5, 13)[EDGE_LT.index(Lt) % 3]
    Lq = Lt + 17 if Lt < 100 else (2 * Lt) // 3 + 1
    dev = torch.device("cuda")
    saa, s3d = torch.from_numpy(SAA).to(dev), torch.from_numpy(S3D).to(dev)
    modes = [dict(gap_window=w) for w in EDGE_WINDOWS + [Lt, 2 * Lt]] + [dict(ungapped=True)]
    for n, case in enumerate(SW_EDGE_CASES):
        arrays, go, ge = sw_edge_pairs(np.random.RandomState(Lt * 10 + n), case, B, Lq, Lt)
        t = [torch.from_numpy(x).to(dev) for x in arrays]
        for kw in modes:
            k = sw_cuda.sw_forward_cuda(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            p = tsw.sw_forward_plain(*t[:6], saa, s3d, go=go, ge=ge, qc=t[6], **kw)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a, b), (case, kw, B, Lq, Lt)


@pytest.mark.cuda
def test_kernel_rejects_too_wide_targets():
    need_cuda()
    t = _inputs(1, "off", 2, 64)
    wide = torch.zeros((2, sw_cuda.MAX_LT + 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_cuda(t[0], t[1], wide, wide, *t[4:8])


@pytest.mark.cuda
def test_candidate_pairs_exact_on_cuda_under_tf32():
    """The shared-k-mer counts are exact on the card even with TF32 on for
    float32 products: the same pairs as on the CPU."""
    need_cuda()
    rng = np.random.RandomState(3)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    aa = []
    for _ in range(40):
        base = rng.choice(letters, rng.randint(150, 900))
        for _ in range(4):
            s = base.copy()
            pos = rng.randint(0, len(s), len(s) // 5)
            s[pos] = rng.choice(letters, len(pos))
            aa.append("".join(s))
    ss = MockProstT5().predict(aa)
    ref = prefilter.candidate_pairs(aa, ss, coverage=0.8, device="cpu")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        out = prefilter.candidate_pairs(aa, ss, coverage=0.8, device="cuda")
    finally:
        torch.set_float32_matmul_precision(prev)
    assert out == ref and len(ref) > 0
