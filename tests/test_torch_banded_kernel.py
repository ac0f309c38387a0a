"""The banded kernel's wrapper (ops/banded_cuda.py) on CPU tensors, where
it runs the plain version, against that version and JAX's
sw_forward_banded; the plain version's row limit (`row_limit`); and the
engine's split of `banded.seconds`.  Inputs from a numpy seed;
bit-identical.  The kernel itself runs in tests/test_torch_banded_cuda.py
(on the card)."""

import numpy as np
import pytest
import torch

from test_torch_banded import S3D, SAA, _band_batch
from torch_port_helpers import as_torch, port_env  # noqa: F401  (fixture)
from unicore_tpu.ops import banded as jb
from unicore_tpu_torch.align import engine as teng_mod
from unicore_tpu_torch.ops import banded as tb
from unicore_tpu_torch.ops import banded_cuda
from unicore_tpu_torch.runtime import profiling

MODES = {"w64": dict(gap_window=64), "w0": dict(gap_window=0), "ungapped": dict(ungapped=True)}
W = 128


def _edge_batch(seed, bias):
    """_band_batch's planted pairs (B 8, L 256), then rows whose band lies
    partly left of the target, partly past its end, wholly outside the
    matrix, and a query of length 1."""
    qa, qs, ta, ts, ql, tl, d0, qc = _band_batch(seed, 8, 256, 256, bias)
    d0[4] = -W // 2 - 30
    d0[5] = tl[5] - 20
    d0[6] = 256 + W
    d0[7] = -(256 + W)
    ql[3] = 1
    return qa, qs, ta, ts, ql, tl, d0, qc


def _jax(arrays, kw, saa):
    import jax.numpy as jnp

    *x, qc = arrays
    return [np.asarray(r) for r in jb.sw_forward_banded(
        *(jnp.asarray(a) for a in (*x, saa, S3D)), qc=None if qc is None else jnp.asarray(qc), **kw)]


def _held(arrays, kw, saa=SAA):
    """The wrapper on CPU tensors against the plain version and JAX."""
    t = as_torch(*arrays[:7], saa, S3D, arrays[7])
    before = dict(banded_cuda.LAUNCHES)
    got = banded_cuda.sw_forward_banded_cuda(*t[:9], qc=t[9], **kw)
    assert banded_cuda.LAUNCHES == before  # the CPU runs no kernel
    plain = tb.sw_forward_banded(*t[:9], qc=t[9], **kw)
    ref = _jax(arrays, kw, saa)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == p.dtype and g.numpy().dtype == r.dtype
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy(), r), (g, r)
    return got


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("go,ge", [(100.0, 10.0), (28.0, 3.0)])
def test_wrapper_on_cpu_matches_plain_and_jax(mode, bias, go, ge):
    arrays = _edge_batch(7, bias)
    best, qend, tend = _held(arrays, dict(W=W, go=go, ge=ge, **MODES[mode]))
    assert float(best[:4].max()) > 0
    assert float(best[6]) == 0 and float(best[7]) == 0  # bands wholly outside
    assert int(qend[3]) == 0  # qlen 1


@pytest.mark.parametrize("width", [33, 300])
def test_odd_and_wider_than_target_bands(width):
    """Odd W and W > Lt: the kernel takes both (the engine sends neither)."""
    _held(_band_batch(5, 4, 256, 256, True), dict(W=width, gap_window=64))


def test_wrapper_rejects():
    t = as_torch(*_band_batch(5, 2, 256, 256, False)[:7], SAA, S3D)
    with pytest.raises(ValueError, match="W must be >= 1"):
        banded_cuda.sw_forward_banded_cuda(*t, W=0)
    with pytest.raises(ValueError, match="gap_window"):
        banded_cuda.sw_forward_banded_cuda(*t, gap_window=-1)
    with pytest.raises(TypeError, match="d0"):
        banded_cuda.sw_forward_banded_cuda(*t[:6], t[6].long(), *t[7:])


def _short_batch(bias):
    """Planted pairs of 80-96 residues padded to Lq = Lt = 256."""
    qa, qs, ta, ts, ql, tl, d0, qc = _band_batch(9, 4, 160, 160, bias)
    pad = lambda x: np.pad(x, ((0, 0), (0, 96)), constant_values=20)  # noqa: E731
    qc = None if qc is None else np.pad(qc, ((0, 0), (0, 96)))
    return pad(qa), pad(qs), pad(ta), pad(ts), ql, tl, d0, qc


def test_row_limit():
    qa, qs, ta, ts, ql, tl, d0, qc = (None if x is None else torch.from_numpy(x)
                                      for x in _short_batch(True))
    saa, s3d = torch.from_numpy(SAA), torch.from_numpy(S3D)
    top = int(ql.max())
    assert top < 100
    lim = lambda **kw: tb.row_limit(**{**dict(  # noqa: E731
        qlen=ql, saa=saa, s3d=s3d, W=W, go=100.0, ge=10.0, w_aa=4.0, w_3di=6.0,
        ungapped=False, qc=qc, Lq=256), **kw})
    assert lim() == top
    assert lim(qc=None) == top
    assert lim(ungapped=True, saa=saa + 0.375) == top
    assert lim(saa=saa + 0.375) == 256  # w_aa * saa not integer-valued
    assert lim(w_aa=4.25) == 256
    assert lim(go=-10.0) == 256       # a gap bonus
    assert lim(ge=2.5) == 256
    big = qc.clone()
    big[0, 0] = 1 << 24
    assert lim(qc=big) == 256         # past the 2^24 bound
    big[0, :] = 0
    big[0, 200] = 1 << 24             # past qlen: not read
    assert lim(qc=big) == top


@pytest.mark.parametrize("mode", ["w64", "ungapped"])
@pytest.mark.parametrize("matrix", ["integer", "fractional"])
def test_short_loop_matches_jax(mode, matrix):
    """The plain loop stops at the longest qlen (far below Lq) with integer
    matrices and runs every row with a fractional one: JAX's results on
    both."""
    saa = SAA if matrix == "integer" else (SAA + np.float32(0.375)).astype(np.float32)
    _held(_short_batch(True), dict(W=W, **MODES[mode]), saa)


def test_engine_splits_banded_seconds(port_env):  # noqa: F811
    """`_banded_pass` on the CPU: seed, pack and device seconds sum to
    banded.seconds, and every batch is counted."""
    eng = teng_mod.AlignmentEngine(teng_mod.AlignParams(long_threshold=150, band_width=128),
                                   device="cpu")
    arrays = _band_batch(4, 6, 256, 256, False)
    qa, qs, ta, ts, ql, tl = arrays[:6]
    entries = [(b, qa[b, :ql[b]], qs[b, :ql[b]], ta[b, :tl[b]], ts[b, :tl[b]]) for b in range(6)]
    rng = np.random.RandomState(2)
    entries.append((6, *(rng.randint(0, 20, 200).astype(np.int32) for _ in range(4))))  # seedless
    profiling.reset_counters()
    out = eng._banded_pass(entries)
    c = profiling.get_counters()
    parts = c["banded.seed.seconds"] + c["banded.pack.seconds"] + c["banded.device.seconds"]
    assert parts == pytest.approx(c["banded.seconds"], rel=1e-9, abs=1e-9)
    assert min(c["banded.seed.seconds"], c["banded.pack.seconds"], c["banded.device.seconds"]) > 0
    assert c["banded.launches"] >= 1
    assert len(out) == 7 and out[0][0] > 0
