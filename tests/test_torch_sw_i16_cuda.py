"""The SW kernel's int16 instance (csrc/sw.cu, dp_dtype="i16") against the
plain int16 DP (ops/sw.py::sw_forward_i16), and the int16 probes
(scripts/torch_probe_i16.py), on the card.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sw_i16_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import need_cuda, random_pairs
from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.ops import sw as tsw
from unicore_tpu_torch.ops import sw_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
MODES = {"w64": dict(gap_window=64), "w0": dict(gap_window=0), "ungapped": dict(ungapped=True)}
# (B, L, go, ge): the engine's buckets, at ge = 10 up to 256 columns and at
# ge = 1 above (the int16 contract: L*ge + 30150 < 32767)
SHAPES = [(512, 128, 100, 10), (512, 256, 100, 10), (64, 1024, 10, 1), (16, 2048, 10, 1)]


def hot_pairs(seed, B, L, bias):
    """Ragged random pairs; every fourth pair is a self pair, which reaches
    the cap (gapped) or wraps (ungapped) from about 500 columns on, and
    with bias on its rows take +255, cells past JAX's < 150 assumption."""
    rng = np.random.RandomState(seed)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, B, L, L)
    hot = np.arange(1, B, 4)
    ta[hot], ts[hot], tl[hot] = qa[hot], qs[hot], ql[hot]
    qc = None
    if bias == "on":
        qc = rng.randint(-60, 40, qa.shape).astype(np.int32)
        qc[hot] = 255
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (qa, qs, ta, ts, ql, tl)]
    return t, None if qc is None else torch.from_numpy(qc).to(dev)


def mats():
    dev = torch.device("cuda")
    return torch.from_numpy(SAA).to(dev), torch.from_numpy(S3D).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bias", ["off", "on"])
@pytest.mark.parametrize("B,L,go,ge", SHAPES)
def test_i16_kernel_matches_plain(B, L, go, ge, mode, bias):
    need_cuda()
    saa, s3d = mats()
    t, qc = hot_pairs(B + L, B, L, bias)
    kind = "ungapped_i16" if mode == "ungapped" else "gapped_i16"
    before = dict(sw_cuda.LAUNCHES), sw_cuda.I16_LAUNCHES[kind]
    k = sw_cuda.sw_forward_cuda(*t, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **MODES[mode])
    torch.cuda.synchronize()
    assert sw_cuda.I16_LAUNCHES[kind] == before[1] + 1
    assert sw_cuda.LAUNCHES == before[0]  # the main path's counts do not move
    p = tsw.sw_forward_plain(*t, saa, s3d, go=go, ge=ge, qc=qc, dp_dtype="i16", **MODES[mode])
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if L >= 1024:  # the self pairs reach the cap, or wrap
        assert float(k[0].max()) >= 30000


@pytest.mark.cuda
@pytest.mark.parametrize("ungapped,want", [(False, (30000.0, 288, 288)), (True, (32760.0, 314, 314))])
def test_i16_kernel_cap_and_wrap(ungapped, want):
    """A 512 self pair of the highest-scoring residue at ge = 1: the cap
    binds (gapped) or the diagonal wraps (ungapped), as in JAX."""
    need_cuda()
    saa, s3d = mats()
    dev = torch.device("cuda")
    qa = torch.full((1, 512), 17, dtype=torch.int32, device=dev)
    qs = torch.full((1, 512), 10, dtype=torch.int32, device=dev)
    ln = torch.tensor([512], dtype=torch.int32, device=dev)
    k = sw_cuda.sw_forward_cuda(qa, qs, qa, qs, ln, ln, saa, s3d, ge=1.0, ungapped=ungapped,
                                dp_dtype="i16")
    assert (float(k[0][0]), int(k[1][0]), int(k[2][0])) == want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_i16_kernel_equals_f32_kernel_below_the_cap(mode):
    need_cuda()
    saa, s3d = mats()
    rng = np.random.RandomState(4)
    arrays = random_pairs(rng, 256, 256, 256)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    t = [torch.from_numpy(x).cuda() for x in (*arrays, qc)]
    a = sw_cuda.sw_forward_cuda(*t[:6], saa, s3d, qc=t[6], dp_dtype="i16", **MODES[mode])
    b = sw_cuda.sw_forward_cuda(*t[:6], saa, s3d, qc=t[6], **MODES[mode])
    assert bool((b[0] < 30000).all())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_probes_compile_and_match(tmp_path):
    need_cuda()
    out = tmp_path / "probes.json"
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_probe_i16.py"),
                        "--json", str(out)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "12/12 int16 ops compile and match" in r.stdout
