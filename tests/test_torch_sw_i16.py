"""The port's int16 Smith-Waterman DP (`sw_forward_cuda(..., dp_dtype="i16")`
on CPU tensors, i.e. ops/sw.py::sw_forward_i16) against the JAX package's
`sw_forward_pallas(..., dp_dtype="i16", interpret=True)`, on the same
inputs made from a numpy seed: bit-identical on (best, qend, tend).  Random
pairs, then the edges: the cap, the ungapped wrap, cells past the
contract's < 150 assumption, the contract's Lt edge, the Pallas kernel's
default segment packing, the contract's refusals, and the int16 DP equal
to the float32 one below the cap (the statement of JAX's
test_pallas_variants_bit_exact).

The Pallas kernel is held only at powers of two for Lt (it masks columns
with `col & (SEG_L - 1)`).  `batch_tile`, `unroll` and `segments` are its
TPU layout and do not change its results; the small ones below keep its
interpret-mode compile short."""

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch, random_pairs
from unicore_tpu.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu.ops import sw as jsw
from unicore_tpu_torch.ops import sw as tsw
from unicore_tpu_torch.ops import sw_cuda

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
LAYOUT = dict(batch_tile=16, unroll=1, segments=1)
MODES = {"w64": dict(gap_window=64), "w0": dict(gap_window=0), "ungapped": dict(ungapped=True)}


def jax_i16(arrays, qc, layout=LAYOUT, **kw):
    out = jsw.sw_forward_pallas(*arrays, SAA, S3D, qc=qc, dp_dtype="i16", interpret=True,
                                **layout, **kw)
    return [np.asarray(x) for x in out]


def port_i16(arrays, qc, **kw):
    t = as_torch(*arrays, SAA, S3D, qc)
    out = sw_cuda.sw_forward_cuda(*t[:8], qc=t[8], dp_dtype="i16", **kw)
    return [x.numpy() for x in out]


def assert_same(j, p):
    for name, a, b in zip(("best", "qend", "tend"), j, p):
        assert np.array_equal(a, b), (name, np.nonzero(a != b)[0][:8], a[a != b][:8], b[a != b][:8])


@pytest.mark.parametrize("bias", ["off", "on"])
@pytest.mark.parametrize("mode,go,ge", [
    ("w64", 100.0, 10.0), ("w64", 28.0, 3.0), ("w0", 100.0, 10.0), ("w0", 28.0, 3.0),
    ("ungapped", 100.0, 10.0)])
def test_i16_matches_pallas_interpret(mode, go, ge, bias):
    rng = np.random.RandomState(16)
    arrays = random_pairs(rng, 32, 128, 128)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32) if bias == "on" else None
    before = dict(sw_cuda.LAUNCHES), dict(sw_cuda.I16_LAUNCHES)
    p = port_i16(arrays, qc, go=go, ge=ge, **MODES[mode])
    assert (dict(sw_cuda.LAUNCHES), dict(sw_cuda.I16_LAUNCHES)) == before  # no launch on the CPU
    assert_same(jax_i16(arrays, qc, go=go, ge=ge, **MODES[mode]), p)


def self_pair(B, L, aa=17, tdi=10, lens=None):
    """B self pairs of one residue (AA 17 and 3Di 10 score 104 a cell, the
    most of any residue in the default units)."""
    qa = np.full((B, L), aa, np.int32)
    qs = np.full((B, L), tdi, np.int32)
    ln = np.full(B, L, np.int32) if lens is None else np.asarray(lens, np.int32)
    return qa, qs, qa.copy(), qs.copy(), ln, ln.copy()


def f32_plain(arrays, qc=None, **kw):
    t = as_torch(*arrays, SAA, S3D, qc)
    return [x.numpy() for x in tsw.sw_forward_plain(*t[:8], qc=t[8], **kw)]


@pytest.mark.parametrize("ungapped,want", [(False, (30000.0, 288, 288)), (True, (32760.0, 314, 314))])
def test_i16_cap_and_wrap_512_self_pair(ungapped, want):
    """Gapped, H stops at the cap of 30,000 (first reached at (288, 288));
    ungapped, the diagonal reaches 32,760 at (314, 314) and the next cell
    wraps.  The float32 DP gives 53,248 at (511, 511) in both modes."""
    arrays = self_pair(1, 512)
    p = port_i16(arrays, None, ge=1.0, ungapped=ungapped)
    assert_same(jax_i16(arrays, None, ge=1.0, ungapped=ungapped), p)
    assert (float(p[0][0]), int(p[1][0]), int(p[2][0])) == want
    f = f32_plain(arrays, ge=1.0, ungapped=ungapped)
    assert (float(f[0][0]), int(f[1][0]), int(f[2][0])) == (53248.0, 511, 511)


@pytest.mark.parametrize("mode", ["w0", "ungapped"])
def test_i16_cells_past_150_with_bias(mode):
    """A bias of 255 makes cells of 359, rounded by bfloat16 to 360, past
    the contract's < 150 assumption: the capped H plus the column's
    j*ge (ge = 20, Lt*ge + 30150 = 32710) wraps int16 in the E scan, and
    the ungapped diagonal wraps; both sides wrap alike."""
    arrays = self_pair(3, 128, lens=[128, 100, 77])
    qc = np.full((3, 128), 255, np.int32)
    qc[2, ::3] = -255
    p = port_i16(arrays, qc, go=40.0, ge=20.0, **MODES[mode])
    assert_same(jax_i16(arrays, qc, go=40.0, ge=20.0, **MODES[mode]), p)


def test_i16_near_the_lt_edge():
    """ge = 5 at Lt = 512 (Lt*ge + 30150 = 32710, the contract's limit
    32767): self pairs reach the cap, and t = H0 + j*ge comes within 110
    of int16's end; half the pairs are mutated, all ragged."""
    rng = np.random.RandomState(5)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, 4, 512, 512)
    ta[:2], ts[:2], tl[:2] = qa[:2], qs[:2], ql[:2]
    ql[0] = tl[0] = 512
    ta[1, ::7] = rng.randint(0, 20, len(ta[1, ::7]))
    arrays = (qa, qs, ta, ts, ql, tl)
    p = port_i16(arrays, None, go=12.0, ge=5.0)
    assert_same(jax_i16(arrays, None, go=12.0, ge=5.0), p)
    assert p[0][0] == 30000.0


def test_i16_default_segment_packing():
    """The Pallas kernel packs 4 pairs a lane row at Lt = 128: the same
    results."""
    rng = np.random.RandomState(7)
    arrays = random_pairs(rng, 16, 64, 128)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    layout = {k: v for k, v in LAYOUT.items() if k != "segments"}
    assert_same(jax_i16(arrays, qc, layout=layout, gap_window=64), port_i16(arrays, qc, gap_window=64))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("B,L", [(32, 128), (16, 256), (8, 250)])
def test_i16_equals_f32_below_the_cap(mode, B, L):
    rng = np.random.RandomState(L)
    arrays = random_pairs(rng, B, L, L, plant=L)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    f = f32_plain(arrays, qc, **MODES[mode])
    assert (f[0] < 30000).all()
    assert_same(f, port_i16(arrays, qc, **MODES[mode]))


# (what, Lq, Lt, keyword arguments): each refused by JAX's asserts, or by
# the int16 constants it cannot make
REFUSED = [
    ("go not an integer", 8, 128, dict(go=100.5)),
    ("ge not an integer", 8, 128, dict(ge=2.5)),
    ("w_aa not an integer", 8, 128, dict(w_aa=4.5)),
    ("w_3di not an integer", 8, 128, dict(w_3di=0.25)),
    ("Lt*ge + 30150 >= 32767", 8, 128, dict(ge=21.0)),
    ("Lt*ge + 30150 >= 32767 at ge = 1", 8, 2688, dict(go=10.0, ge=1.0)),
    ("Lq >= 32768", 32768, 128, dict()),
    ("go outside int16", 8, 128, dict(go=40000.0)),
    ("go - ge outside int16", 8, 128, dict(go=32767.0, ge=-2.0)),
    ("w_aa + w_3di = 0", 8, 128, dict(w_aa=-6.0)),
]


@pytest.mark.parametrize("what,Lq,Lt,kw", REFUSED, ids=[r[0] for r in REFUSED])
def test_i16_contract_refusals(what, Lq, Lt, kw):
    rng = np.random.RandomState(0)
    arrays = random_pairs(rng, 1, Lq, Lt, minlen=8, plant=8)
    t = as_torch(*arrays, SAA, S3D)
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_cuda(*t, dp_dtype="i16", **kw)
    with pytest.raises((AssertionError, OverflowError, ZeroDivisionError)):
        jsw.sw_forward_pallas(*arrays, SAA, S3D, dp_dtype="i16", interpret=True, **LAYOUT, **kw)


def test_dp_dtype_unknown_refused():
    t = as_torch(*random_pairs(np.random.RandomState(1), 2, 16, 16), SAA, S3D)
    for dt in ("bf16", "int16", ""):
        with pytest.raises(ValueError):
            sw_cuda.sw_forward_cuda(*t, dp_dtype=dt)
        with pytest.raises(ValueError):
            tsw.sw_forward_plain(*t, dp_dtype=dt)
    assert torch.equal(sw_cuda.sw_forward_cuda(*t, dp_dtype="f32")[0], sw_cuda.sw_forward_cuda(*t)[0])
