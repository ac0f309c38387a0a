"""The banded SW kernel (csrc/banded.cu) against its plain version
(ops/banded.py::sw_forward_banded) on the card, bit-exact on (best, qend,
tend).

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_banded_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import need_cuda
from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.ops import banded as tb
from unicore_tpu_torch.ops import banded_cuda
from unicore_tpu_torch.synthetic import BANDED_EDGE_CASES, banded_edge_pairs

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
MODES = {"w0": dict(gap_window=0), "w64": dict(gap_window=64), "ungapped": dict(ungapped=True)}
GRID = [(64, 256, 256, 128), (32, 512, 600, 256), (16, 700, 500, 512), (8, 300, 2100, 1024),
        (4, 200, 3000, 2048), (8, 150, 120, 33), (8, 100, 90, 300)]  # (B, Lq, Lt, W)
ENGINE = [(64, 2048, 2048, 256), (32, 2048, 1024, 512), (8, 2048, 2048, 2048)]


def _on_card(arrays):
    dev = torch.device("cuda")
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]


def _held(arrays, kw, saa=SAA):
    """Kernel against plain on the card; returns the kernel's results."""
    t = _on_card(arrays)
    m = _on_card((saa, S3D))
    kind = "ungapped" if kw.get("ungapped") else "gapped"
    before = banded_cuda.LAUNCHES[kind]
    k = banded_cuda.sw_forward_banded_cuda(*t[:7], *m, qc=t[7], **kw)
    torch.cuda.synchronize()
    assert banded_cuda.LAUNCHES[kind] == before + 1
    p = tb.sw_forward_banded(*t[:7], *m, qc=t[7], **kw)
    for a, b, name in zip(k, p, ("best", "qend", "tend")):
        assert torch.equal(a, b), (name, kw, int((a != b).sum()))
    return k


def _planted(seed, B, Lq, Lt, bias):
    """Long pairs as the engine sends them: a target holding a mutated
    copy of the query at a random shift, ragged lengths, d0 from the
    host vote."""
    rng = np.random.RandomState(seed)
    qa, qs = rng.randint(0, 20, (B, Lq)).astype(np.int32), rng.randint(0, 20, (B, Lq)).astype(np.int32)
    ta, ts = rng.randint(0, 20, (B, Lt)).astype(np.int32), rng.randint(0, 20, (B, Lt)).astype(np.int32)
    ql = rng.randint(Lq // 2 + 1, Lq + 1, B).astype(np.int32)
    tl = rng.randint(Lt // 2 + 1, Lt + 1, B).astype(np.int32)
    d0 = np.zeros(B, np.int32)
    for b in range(B):
        shift = rng.randint(0, max(1, tl[b] - ql[b] // 2))
        n = min(ql[b], tl[b] - shift)
        ta[b, shift:shift + n], ts[b, shift:shift + n] = qa[b, :n], qs[b, :n]
        sub = shift + rng.randint(0, n, n // 5)
        ta[b, sub] = rng.randint(0, 20, len(sub))
        d0[b] = tb.vote_diagonal(qa[b, :ql[b]], qs[b, :ql[b]], ta[b, :tl[b]], ts[b, :tl[b]]) or 0
    qc = rng.randint(-60, 40, (B, Lq)).astype(np.int32) if bias else None
    return qa, qs, ta, ts, ql, tl, d0, qc


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", BANDED_EDGE_CASES)
def test_kernel_matches_plain_on_cuda(mode, case):
    need_cuda()
    rng = np.random.RandomState(17)
    for n, (B, Lq, Lt, W) in enumerate(GRID):
        arrays, go, ge = banded_edge_pairs(rng, case, B, Lq, Lt, W)
        if n % 2:
            arrays = (*arrays[:7], None)  # bias off on every other shape
        _held(arrays, dict(W=W, go=go, ge=ge, **MODES[mode]))
        if mode != "ungapped" and case == "ragged":
            _held(arrays, dict(W=W, go=28.0, ge=3.0, **MODES[mode]))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 2, 3, 16, 48, 100, 512, 1024, 2048])
def test_gap_windows(window):
    """Every E-window mode of the kernel: inside a lane (S <= C), across
    2-32 lanes, and across whole warps in segments of one or more warps
    (W 2,048 and 4,096 are 4 and 8 warps of 512 columns)."""
    need_cuda()
    rng = np.random.RandomState(window)
    for B, Lq, Lt, W in ((8, 200, 300, 256), (4, 150, 2100, 2048), (2, 60, 4200, 4096)):
        for case in ("ragged", "neg_ge"):
            arrays, go, ge = banded_edge_pairs(rng, case, B, Lq, Lt, W)
            _held(arrays, dict(W=W, go=go, ge=ge, gap_window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ENGINE)
def test_engine_shapes(shape):
    need_cuda()
    B, Lq, Lt, W = shape
    arrays = _planted(3, B, Lq, Lt, True)
    for mode in ("w64", "ungapped"):
        best = _held(arrays, dict(W=W, **MODES[mode]))[0]
        assert float(best.min()) > 0


@pytest.mark.cuda
def test_ties():
    """Constant scores: every cell of a diagonal ties."""
    need_cuda()
    rng = np.random.RandomState(4)
    for B, Lq, Lt, W in ((16, 300, 320, 256), (4, 200, 1500, 1024)):
        arrays, go, ge = banded_edge_pairs(rng, "ties", B, Lq, Lt, W)
        for mode in MODES.values():
            _held(arrays, dict(W=W, go=go, ge=ge, **mode))
        zero = np.zeros((21, 21), np.float32)
        _held(arrays, dict(W=W, gap_window=64), saa=zero)


@pytest.mark.cuda
def test_bias_past_2_24():
    need_cuda()
    rng = np.random.RandomState(6)
    arrays, go, ge = banded_edge_pairs(rng, "big_bias", 16, 256, 300, 256)
    assert np.abs(arrays[7]).max() > 1 << 24
    for mode in MODES.values():
        _held(arrays, dict(W=256, go=go, ge=ge, **mode))


@pytest.mark.cuda
def test_widest_band():
    need_cuda()
    W = banded_cuda.MAX_W
    rng = np.random.RandomState(8)
    arrays, go, ge = banded_edge_pairs(rng, "ragged", 4, 48, W + 100, W)
    for mode in ("w0", "w64", "ungapped"):
        _held(arrays, dict(W=W, go=go, ge=ge, **MODES[mode]))
    t = _on_card(arrays)
    m = _on_card((SAA, S3D))
    with pytest.raises(ValueError, match=f"W <= {W}"):
        banded_cuda.sw_forward_banded_cuda(*t[:7], *m, W=W + 1)
