"""The direction-bit DP kernel (csrc/dirbits.cu, both instances) against
its plain versions (ops/nw_device.py::nw_forward_bits and
ops/sw_bits.py::sw_forward_bits) on the card, bit-identical on whole
(B, L1, L2) bits arrays and on (end_i, end_j, score): the callers' full
batches, odd and wide shapes, each row-width class's edge and one past
it, every C through `forward_bits_columns`, one scan a row (go >= ge)
and two (go < ge); and
the callers' launches and their shapes.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dirbits_cuda.py -q

Every test is marked `cuda` and skips where torch.cuda.is_available() is
False."""

import numpy as np
import pytest
import torch

from torch_port_helpers import need_cuda
from unicore_tpu_torch.ops import dirbits_cuda, nw_device, sw_bits
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.synthetic import (
    DIRBITS_KINDS, NW_SCORE_KINDS, SW_WINDOW_KINDS, dirbits_scores, nw_scores, sw_windows,
)

NW_GAPS = [(2816, 256), (1100, 100), (5, 20)]  # the MSA's; another pair; go < ge
SW_GAPS = [(100, 10), (30, 5), (5, 20)]        # the engine's; another pair; go < ge
NW_BATCHES = [(64, 512), (16, 2048), (1, 512), (1, 2048)]  # (B, bucket): the pipeline's full batches, B = 1
SW_BATCHES = [(64, 64), (64, 512), (32, 1024), (8, 2048), (1, 512)]
# (B, L1, L2): widths off the 8-column store, one column, one tile of
# 4,096 columns, a tile and one, two tiles, and 300 x 9,000 (three tiles)
ODD = [(1, 1, 1), (5, 7, 13), (3, 33, 257), (2, 100, 4096), (3, 50, 4097), (2, 40, 8192), (1, 300, 9000)]
KERNELS = {"nw": (dirbits_cuda.nw_forward_bits_cuda, nw_device.nw_forward_bits),
           "sw": (dirbits_cuda.sw_forward_bits_cuda, sw_bits.sw_forward_bits)}
# the kernel table's row-width classes (upper L2), each edge and one past it
CLASS_EDGES = [w + d for w in (64, 128, 256, 512, 1024, 2048, 4096) for d in (0, 1)]


def _held(fn, S, l1, l2, go, ge, C=None):
    """Kernel (the wrapper, or at C columns a lane) against plain on the
    card; returns the kernel's results."""
    kernel, plain = KERNELS[fn]
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (S, l1, l2)]
    kind = "nw" if fn == "nw" else "sw_bits"
    before = dirbits_cuda.LAUNCHES[kind]
    if C is None:
        k = kernel(*t, go, ge)
    else:
        k = dirbits_cuda.forward_bits_columns(C, *t, go, ge, fn == "sw")
    torch.cuda.synchronize()
    assert dirbits_cuda.LAUNCHES[kind] == before + (C is None)
    p = plain(*t, go, ge)
    for a, b, name in zip(k, p, ("bits", "end_i", "end_j", "score")):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, S.dtype, go, ge, int((a != b).sum()))
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lb", NW_BATCHES)
@pytest.mark.parametrize("gaps", NW_GAPS)
def test_nw_kernel_matches_plain(B, Lb, gaps):
    need_cuda()
    rng = np.random.RandomState(B + Lb)
    for n, kind in enumerate(NW_SCORE_KINDS):
        S, l1, l2 = nw_scores(rng, B, Lb, Lb - 5 * n, kind)
        _held("nw", S if n % 2 else S.astype(np.int32), l1, l2, *gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lb", SW_BATCHES)
@pytest.mark.parametrize("gaps", SW_GAPS)
def test_sw_kernel_matches_plain(B, Lb, gaps):
    need_cuda()
    rng = np.random.RandomState(B + Lb + 1)
    for n, kind in enumerate(SW_WINDOW_KINDS):
        S, l1, l2 = sw_windows(rng, B, Lb, kind)
        _held("sw", S if n % 2 else S.astype(np.int32), l1, l2, *gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", list(KERNELS))
@pytest.mark.parametrize("shape", ODD)
def test_odd_and_wide_shapes(fn, shape):
    need_cuda()
    rng = np.random.RandomState(sum(shape))
    for kind in DIRBITS_KINDS:
        for dtype in (np.int16, np.int32):
            _held(fn, *dirbits_scores(rng, *shape, kind, dtype), *(NW_GAPS[0] if fn == "nw" else SW_GAPS[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", list(KERNELS))
@pytest.mark.parametrize("L2", CLASS_EDGES)
def test_width_class_edges(fn, L2):
    """Each row-width class's upper edge and one past it at the table's C,
    one scan a row (the callers' gaps, go == ge) and two (go < ge)."""
    need_cuda()
    rng = np.random.RandomState(L2 + len(fn))
    gaps = (NW_GAPS[0] if fn == "nw" else SW_GAPS[0], (10, 10), NW_GAPS[2])
    for n, (go, ge) in enumerate(gaps):
        _held(fn, *dirbits_scores(rng, 3, 24, L2, DIRBITS_KINDS[n % 2], (np.int16, np.int32)[(n + L2) % 2]), go, ge)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", list(KERNELS))
@pytest.mark.parametrize("C", dirbits_cuda.COLUMNS)
def test_every_columns_count(fn, C):
    """Every C the kernel has (forward_bits_columns): one warp, several,
    the widest single tile, a tile and one, and two whole tiles, int16 and
    int32 S; one scan (the callers' gaps, go == ge) and two (go < ge)."""
    need_cuda()
    maxt = dirbits_cuda.band_threads(C)
    rng = np.random.RandomState(C + len(fn))
    caller = NW_GAPS[0] if fn == "nw" else SW_GAPS[0]
    for n, L2 in enumerate([32 * C - 3, 128 * C, maxt * C, maxt * C + 1, 2 * maxt * C]):
        for m, dtype in enumerate((np.int16, np.int32)):
            arrays = dirbits_scores(rng, 3, 20, L2, DIRBITS_KINDS[(n + m) % 2], dtype)
            for go, ge in (caller, (10, 10), (5, 20)):
                _held(fn, *arrays, go, ge, C=C)


@pytest.mark.cuda
def test_callers_shapes_counted():
    """A wrapper launch counts its (B, L1, L2) in SHAPES, which the CLI's
    counters carry (shape_counters)."""
    need_cuda()
    dirbits_cuda.reset_launch_counts()
    rng = np.random.RandomState(8)
    for _ in range(2):
        _held("nw", *dirbits_scores(rng, 4, 64, 64), *NW_GAPS[0])
    _held("sw", *dirbits_scores(rng, 2, 128, 128), *SW_GAPS[0])
    assert dirbits_cuda.SHAPES == {"nw": {(4, 64, 64): 2}, "sw_bits": {(2, 128, 128): 1}}
    assert dirbits_cuda.shape_counters() == {"kernel.dirbits.nw.shape.4x64x64": 2,
                                             "kernel.dirbits.sw_bits.shape.2x128x128": 1}


@pytest.mark.cuda
def test_wrapper_rejects_on_cuda():
    need_cuda()
    S = torch.zeros((2, 0, 5), dtype=torch.int16, device="cuda")
    l = torch.ones(2, dtype=torch.int32, device="cuda")
    for kernel, _ in KERNELS.values():
        with pytest.raises(ValueError, match="L1, L2"):
            kernel(S, l, l, 100, 10)
        with pytest.raises(ValueError, match="on cpu"):
            kernel(torch.zeros((2, 3, 5), dtype=torch.int16, device="cuda"), l.cpu(), l, 100, 10)
    S = torch.zeros((2, 3, 5), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError, match="C must be one of"):
        dirbits_cuda.forward_bits_columns(3, S, l, l, 100, 10, False)


@pytest.mark.cuda
def test_callers_launch_the_kernel():
    """The merge pipeline, nw_align_batch and sw_traceback_batch on the
    card: one launch per dispatch, counted as the plain versions count,
    and the same results as on the CPU."""
    need_cuda()
    from test_torch_nw_cuda import _entries
    from unicore_tpu_torch.msa import progressive
    from unicore_tpu_torch.ops import nw as tnw

    rng = np.random.RandomState(2)
    eng = progressive.ProgressiveMSA(mode="3di+aa", device="cpu")
    args = (eng.go_q, eng.ge_q, eng.saa, eng.s3d, eng._wA, eng._wS)
    entries = _entries(rng, 12, 6, 200)
    S_list = [tnw.quantize_scores(rng.randn(a, b) * 2.0 - 1.0) for a, b in [(12, 17), (1, 9), (70, 300)]]
    windows = [rng.randint(-30, 25, (a, b)).astype(np.int32) for a, b in [(3, 5), (40, 70), (200, 130)]]
    runs = {
        "nw": (lambda dev: nw_device.nw_align_batch_counts(entries, *args, device=dev), "msa.dispatches"),
        "nw_host_scored": (lambda dev: nw_device.nw_align_batch(S_list, 2816, 256, device=dev), "msa.dispatches"),
        "sw_bits": (lambda dev: sw_bits.sw_traceback_batch(windows, 100, 10, device=dev), "traceback.dispatches"),
    }
    for name, (run, counter) in runs.items():
        cpu = run("cpu")
        dirbits_cuda.reset_launch_counts()
        profiling.reset_counters()
        got = run("cuda")
        n = profiling.get_counters()[counter]
        assert n > 0 and dirbits_cuda.LAUNCHES["sw_bits" if name == "sw_bits" else "nw"] == n, name
        if name == "sw_bits":
            assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
                       for a, b in zip(got, cpu))
        else:
            assert got == cpu, name
