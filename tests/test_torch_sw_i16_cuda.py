"""The SW kernel's int16 instance (csrc/sw.cu's sw_i16_kernel, dp_dtype="i16":
two int16 columns to a word, a warp's block of 64 columns a word folded in
two) against the plain int16 DP (ops/sw.py::sw_forward_i16), at the
engine's buckets and at shapes that straddle the fold (the seam): odd Lt,
tlen in the second half, windows of 0 to past Lt, Lt at the contract's
edge, one to eight warps a pair at each words-a-lane count of the
kernel's table; and the int16
probes (scripts/torch_probe_i16.py), on the card.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sw_i16_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import importlib.util
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


def seam_pairs(seed, B, Lq, Lt):
    """Ragged pairs whose targets end anywhere, most past the middle of Lt
    (the fold of a one-warp block), every fourth a self pair."""
    rng = np.random.RandomState(seed)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, B, Lq, Lt, minlen=4)
    ql[5::8], tl[6::8] = 1, 1
    tl[::2] = rng.randint(Lt // 2, Lt + 1, len(tl[::2]))
    hot = np.arange(3, B, 4)
    n = min(Lq, Lt)
    ta[hot, :n], ts[hot, :n] = qa[hot, :n], qs[hot, :n]
    qc = rng.randint(-60, 40, (B, Lq)).astype(np.int32)
    qc[hot[::2]] = 255
    dev = torch.device("cuda")
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (qa, qs, ta, ts, ql, tl)], \
        torch.from_numpy(qc).to(dev)


# (B, Lq, Lt, go, ge): odd Lt, one warp and one column past it at each words
# count of the table (so every compiled instance, gapped and ungapped), up
# to 8 warps, and Lt at the contract's edge (ge 1: 2,616 + 30,150 < 32,767)
SEAM_SHAPES = [(64, 100, 127, 100, 10), (64, 100, 129, 100, 10), (32, 200, 255, 100, 10),
               (32, 200, 257, 28, 3), (16, 300, 1023, 10, 1), (16, 150, 1025, 10, 1),
               (16, 150, 2049, 10, 1),
               (8, 100, 2616, 10, 1), (4, 40, 4096, 10, 0)]
SEAM_WINDOWS = [0, 1, 3, 8, 64, 100, 512, 5000]


def assert_kernel_matches_plain(t, qc, saa, s3d, **kw):
    k = sw_cuda.sw_forward_cuda(*t, saa, s3d, qc=qc, dp_dtype="i16", **kw)
    torch.cuda.synchronize()
    p = tsw.sw_forward_plain(*t, saa, s3d, qc=qc, dp_dtype="i16", **kw)
    for name, a, b in zip(("best", "qend", "tend"), k, p):
        bad = (a != b).nonzero().flatten()[:8].tolist()
        assert not bad, (name, kw, bad, a[bad].tolist(), b[bad].tolist())


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
@pytest.mark.parametrize("B,Lq,Lt,go,ge", SEAM_SHAPES)
def test_i16_kernel_seam_shapes(B, Lq, Lt, go, ge):
    """Every window of SEAM_WINDOWS (each windowed-max mode, windows across
    the fold and one to several warps back) and the ungapped mode, bias on."""
    need_cuda()
    saa, s3d = mats()
    t, qc = seam_pairs(Lt, B, Lq, Lt)
    for gw in SEAM_WINDOWS:
        assert_kernel_matches_plain(t, qc, saa, s3d, go=go, ge=ge, gap_window=gw)
    assert_kernel_matches_plain(t, qc, saa, s3d, go=go, ge=ge, ungapped=True)


@pytest.mark.cuda
@pytest.mark.parametrize("Lt", [250, 700])
def test_i16_kernel_odd_gaps_and_weights(Lt):
    """go < 0 (every row runs, rows past qlen on the pad code), ge < 0,
    go - ge = -20,002 (column 0's E positive), and weights that send every
    row to the per-cell score; one warp a pair (250) and three (700)."""
    need_cuda()
    saa, s3d = mats()
    t, qc = seam_pairs(9, 32, 80, Lt)
    for go, ge in ((-3, 2), (6, -1), (-20001, 1), (10, -40)):
        for kw in (dict(gap_window=0), dict(gap_window=64), dict(ungapped=True)):
            assert_kernel_matches_plain(t, qc, saa, s3d, go=go, ge=ge, **kw)
    assert_kernel_matches_plain(t, qc, saa, s3d, ge=1.0, w_aa=40.0, w_3di=3.0, gap_window=64)


@pytest.mark.cuda
@pytest.mark.parametrize("Lt", [1, 2, 3])
def test_i16_kernel_tiny_targets(Lt):
    """Targets of 1 to 3 columns, queries of 1 to 5 rows, qlen and tlen 0
    among them, every mode, go >= 0 and go < 0."""
    need_cuda()
    saa, s3d = mats()
    rng = np.random.RandomState(Lt)
    qa = rng.randint(0, 20, (6, 5)).astype(np.int32)
    ta = rng.randint(0, 20, (6, Lt)).astype(np.int32)
    ql = np.array([0, 1, 5, 3, 5, 2], np.int32)
    tl = np.array([Lt, Lt, 0, 1, Lt, Lt], np.int32)
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (qa, qa[:, ::-1], ta, ta, ql, tl)]
    for kw in MODES.values():
        assert_kernel_matches_plain(t, None, saa, s3d, **kw)
        assert_kernel_matches_plain(t, None, saa, s3d, go=-3, ge=2, **kw)


def probe_count():
    spec = importlib.util.spec_from_file_location("torch_probe_i16", os.path.join(REPO, "scripts", "torch_probe_i16.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return len(mod.PROBES)


@pytest.mark.cuda
def test_probes_compile_and_match(tmp_path):
    need_cuda()
    out = tmp_path / "probes.json"
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_probe_i16.py"),
                        "--json", str(out)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    n = probe_count()
    assert n == 20 and f"{n}/{n} int16 ops compile and match" in r.stdout
