"""The port's Smith-Waterman (ops/sw.py, ops/sw_cuda.py) against the JAX
package's, on the same inputs made from a numpy seed.

Every comparison is bit-identical: the DP is integer-valued in float32,
and the port keeps the JAX functions' operation order."""

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch, random_pairs
from unicore_tpu.align.bias import bias_clip_bound
from unicore_tpu.matrices import BLOSUM62, default_3di_matrix
from unicore_tpu.ops import sw as jsw
from unicore_tpu_torch.ops import sw as tsw
from unicore_tpu_torch.ops import sw_cuda
from unicore_tpu_torch.synthetic import SW_EDGE_CASES, sw_edge_pairs

SAA = BLOSUM62.astype(np.float32)
S3D = default_3di_matrix().astype(np.float32)
MODES = {"w0": dict(gap_window=0), "w64": dict(gap_window=64), "ungapped": dict(ungapped=True)}
# windows the kernel's shuffle scan finds hardest: shorter than, equal to and
# longer than a lane's columns, not a power of two, and Lt or 2*Lt (the
# tests below use Lt = 128)
MODES.update({f"w{w}": dict(gap_window=w) for w in (1, 2, 3, 48, 100, 128, 256)})
GAPS = [(100.0, 10.0), (28.0, 3.0)]


def _inputs(seed, bias, B=8, Lq=128, Lt=128):
    rng = np.random.RandomState(seed)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, B, Lq, Lt)
    if bias == "off":
        qc = None
    elif bias == "on":
        qc = rng.randint(-150, 40, qa.shape).astype(np.int32)
    else:  # exactly +-bias_clip_bound, the largest |qc| composition_bias emits
        bound = int(bias_clip_bound(SAA, S3D, 4.0, 6.0))
        qc = rng.choice([-bound, bound], size=qa.shape).astype(np.int32)
    return qa, qs, ta, ts, ql, tl, qc


def _jax_xla(qa, qs, ta, ts, ql, tl, qc, go, ge, mode):
    sc = jsw.build_scores(qa, qs, ta, ts, ql, tl, SAA, S3D, qc=qc)
    if mode == "ungapped":
        return jsw.ungapped_forward_xla(sc)
    return jsw.sw_forward_xla(sc, go=go, ge=ge, gap_window=MODES[mode]["gap_window"])


def _port(qa, qs, ta, ts, ql, tl, qc, go, ge, mode):
    t = as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D, qc)
    return sw_cuda.sw_forward_cuda(*t[:8], go=go, ge=ge, qc=t[8], **MODES[mode])


def _assert_same(ref, out):
    for r, o in zip(ref, out):
        r = np.asarray(r)
        o = o.cpu().numpy()
        assert r.dtype == o.dtype, (r.dtype, o.dtype)
        assert np.array_equal(r, o), (r, o)


@pytest.mark.parametrize("go,ge", GAPS)
@pytest.mark.parametrize("bias", ["off", "on", "clip"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_jax_xla(mode, bias, go, ge):
    args = _inputs(1, bias, B=8, Lq=96, Lt=128)
    _assert_same(_jax_xla(*args, go, ge, mode), _port(*args, go, ge, mode))


@pytest.mark.parametrize("Lq,Lt", [(40, 100), (100, 33)])
@pytest.mark.parametrize("mode", ["w0", "w3", "w64", "ungapped"])
@pytest.mark.parametrize("case", SW_EDGE_CASES)
def test_plain_matches_jax_xla_on_edge_inputs(case, mode, Lq, Lt):
    """Lq != Lt, lengths of 1, tie-heavy pairs, best cells past tlen or
    qlen, and a bias beyond float32's exact integers."""
    (qa, qs, ta, ts, ql, tl, qc), go, ge = sw_edge_pairs(np.random.RandomState(11), case, 7, Lq, Lt)
    _assert_same(_jax_xla(qa, qs, ta, ts, ql, tl, qc, go, ge, mode),
                 _port(qa, qs, ta, ts, ql, tl, qc, go, ge, mode))


def test_build_scores_matches_jax():
    qa, qs, ta, ts, ql, tl, qc = _inputs(2, "on", B=4, Lq=40, Lt=56)
    ref = jsw.build_scores(qa, qs, ta, ts, ql, tl, SAA, S3D, qc=qc)
    out = tsw.build_scores(*as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D), qc=torch.from_numpy(qc))
    assert out.dtype == torch.float32
    assert np.array_equal(ref, out.numpy())


@pytest.mark.parametrize("window", [0, 1, 3, 64, 500])
def test_prefix_max_matches_jax(window):
    t = np.random.RandomState(3).randint(-50, 50, (3, 200)).astype(np.float32)
    ref = np.asarray(jsw._prefix_max(t, window=window))
    assert np.array_equal(ref, tsw._prefix_max(torch.from_numpy(t), window=window).numpy())


@pytest.mark.parametrize("mode,bias,go,ge", [
    ("w64", "on", 100.0, 10.0),
    ("w0", "off", 28.0, 3.0),
    ("ungapped", "clip", 100.0, 10.0),
    ("w64", "clip", 28.0, 3.0),
])
def test_plain_matches_pallas_interpret(mode, bias, go, ge):
    """The port against the TPU kernel itself, run by Pallas's interpreter."""
    qa, qs, ta, ts, ql, tl, qc = _inputs(4, bias)
    ref = jsw.sw_forward_pallas(
        qa, qs, ta, ts, ql, tl, SAA, S3D, go=go, ge=ge, batch_tile=8,
        interpret=True, qc=qc, **MODES[mode])
    _assert_same(ref, _port(qa, qs, ta, ts, ql, tl, qc, go, ge, mode))


@pytest.mark.parametrize("mode", list(MODES))
def test_padding_does_not_change_results(mode):
    """Each pair scored alone at its exact size gives what it gives inside
    the padded batch.  This holds for a gap open >= 0 with integral scores,
    the case here; a negative gap open can carry E or F into the padding
    (the `gap_bonus` edge case)."""
    qa, qs, ta, ts, ql, tl, qc = _inputs(5, "on", B=6, Lq=128, Lt=128)
    full = _port(qa, qs, ta, ts, ql, tl, qc, 100.0, 10.0, mode)
    for b in range(qa.shape[0]):
        q, t = ql[b], tl[b]
        one = _port(qa[b:b + 1, :q], qs[b:b + 1, :q], ta[b:b + 1, :t], ts[b:b + 1, :t],
                    ql[b:b + 1], tl[b:b + 1], qc[b:b + 1, :q], 100.0, 10.0, mode)
        assert [x[b].item() for x in full] == [x[0].item() for x in one], b


def test_wrapper_takes_plain_path_on_cpu():
    qa, qs, ta, ts, ql, tl, qc = _inputs(6, "on", B=4, Lq=64, Lt=64)
    t = as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D, qc)
    before = dict(sw_cuda.LAUNCHES)
    out = sw_cuda.sw_forward_cuda(*t[:8], gap_window=64, qc=t[8])
    plain = tsw.sw_forward_plain(*t[:8], gap_window=64, qc=t[8])
    assert sw_cuda.LAUNCHES == before  # no kernel launch on CPU tensors
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_plain_chunking_does_not_change_results(monkeypatch):
    qa, qs, ta, ts, ql, tl, qc = _inputs(7, "on", B=6, Lq=64, Lt=64)
    t = as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D, qc)
    whole = tsw.sw_forward_plain(*t[:8], qc=t[8])
    monkeypatch.setattr(tsw, "_PLAIN_CHUNK_CELLS", 64 * 64 * 4)  # chunks of 4 pairs
    for a, b in zip(whole, tsw.sw_forward_plain(*t[:8], qc=t[8])):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    qa, qs, ta, ts, ql, tl, _ = _inputs(8, "off", B=2, Lq=32, Lt=32)
    t = list(as_torch(qa, qs, ta, ts, ql, tl, SAA, S3D))
    with pytest.raises(TypeError):
        sw_cuda.sw_forward_cuda(t[0].long(), *t[1:])
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_cuda(t[0], t[1][:, :16].contiguous(), *t[2:])
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_cuda(t[0].t().contiguous().t(), *t[1:])
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_cuda(*t[:6], t[6][:20, :20].contiguous(), t[7])
