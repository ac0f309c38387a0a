"""Wrapper of the Hopper direction-bit DP kernel (`csrc/dirbits.cu`).

`nw_forward_bits_cuda` takes the inputs of ops/nw_device.py::nw_forward_bits
(unicore_tpu.ops.nw_device.nw_forward_bits, the MSA merge's semi-global NW)
and `sw_forward_bits_cuda` those of ops/sw_bits.py::sw_forward_bits
(unicore_tpu.ops.sw_bits.sw_forward_bits, the m8 traceback's local SW); each
returns (bits (B, L1, L2) uint8, end_i, end_j, score (B,) int32).  On CUDA
tensors they launch the kernel on the current stream, without
synchronising, or raise; on CPU tensors they run the plain version.  There
is no fallback from one to the other.

The kernel is compiled at first use by `nvcc` for sm_90a with
ops/sw_cuda.py's flags (`sw_cuda.build_library`) into a shared library with
a plain C interface under `build/unicore_tpu_torch/`, keyed by a hash of the
source and the flags, and loaded with ctypes.  The kernel runs one scan a
row where go >= ge (exact there) and two otherwise.  `columns_of` reads the
kernel's table of columns a lane (C) by row width and `band_threads` its
threads a block by C; `forward_bits_columns` launches it at another C, for
the sweep of chip_smoke.py phase 3f and the card's tests.  Rows wider than
one band of columns (4,096 for the table's widest class) are walked band
by band, each band's per-row values for the next in a scratch tensor that
the wrapper allocates (`dirbits_forward_scratch_ints`).

On the card the wrappers add the counters the plain versions add, with the
same meaning per call: `msa.dispatches` and `msa.nw.seconds`, or
`traceback.dispatches` and `traceback.seconds` (the host wall time of the
call; the waits for the results are counted where they are collected).

`LAUNCHES` counts the launches per instance ("nw", "sw_bits"), so a run
can show that its main path went through the kernel; `SHAPES` counts them
per instance and launch shape (B, L1, L2), for the launch-shape
histograms of chip_smoke.py phases 4 and 7a.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from unicore_tpu_torch.ops import nw_device, sw_bits, sw_cuda
from unicore_tpu_torch.runtime import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dirbits.cu"

COLUMNS = (2, 4, 8)  # the kernel's columns a lane (C)

LAUNCHES: Dict[str, int] = {"nw": 0, "sw_bits": 0}
SHAPES: Dict[str, Dict[Tuple[int, int, int], int]] = {"nw": {}, "sw_bits": {}}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()


def shape_counters() -> Dict[str, int]:
    """SHAPES as counters: `kernel.dirbits.{instance}.shape.{B}x{L1}x{L2}`
    -> launches."""
    return {f"kernel.dirbits.{k}.shape.{B}x{L1}x{L2}": n
            for k, shapes in SHAPES.items() for (B, L1, L2), n in shapes.items()}


def bind(so: Path) -> ctypes.CDLL:
    """Load a library built from csrc/dirbits.cu and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.dirbits_forward_launch.argtypes = [
        _P, _I, _P, _P, _I, _I,  # S s_int16 l1 l2 go ge
        _I, _I, _I, _I, _I,  # B L1 L2 local C
        _P, _P, _P, _P, _P, _P,  # bits end_i end_j score scratch stream
    ]
    lib.dirbits_forward_launch.restype = ctypes.c_int
    lib.dirbits_forward_columns.argtypes = [_I]
    lib.dirbits_forward_columns.restype = ctypes.c_int
    lib.dirbits_forward_scratch_ints.argtypes = [_I, _I, _I, _I]
    lib.dirbits_forward_scratch_ints.restype = ctypes.c_longlong
    return lib


def load() -> ctypes.CDLL:
    """Build the kernel's library if it is not built yet, and load it."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        _LIB = bind(sw_cuda.build_library(source=SOURCE))
        return _LIB


def build() -> float:
    """Build (if needed) and load the kernel; returns the seconds taken."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def columns_of(L2: int) -> int:
    """The kernel's table: columns a lane for rows of L2 columns (builds the
    kernel if needed)."""
    return load().dirbits_forward_columns(int(L2))


@functools.lru_cache(maxsize=None)
def _max_threads_rule() -> Tuple[int, int, int]:
    m = re.search(r"max_threads\(int C\) \{ return C <= (\d+) \? (\d+) : (\d+); \}", SOURCE.read_text())
    if m is None:
        raise RuntimeError(f"band_threads: no max_threads rule in {SOURCE}")
    return int(m.group(1)), int(m.group(2)), int(m.group(3))


def band_threads(C: int) -> int:
    """Threads a block of the kernel may have at C columns a lane, read from
    the source's max_threads (no build needed): a row of up to
    band_threads(C) * C columns is one band."""
    upto, low, high = _max_threads_rule()
    return low if C <= upto else high


def _checked(what: str, S: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor) -> None:
    if not isinstance(S, torch.Tensor):
        raise TypeError(f"{what}: S: expected a torch.Tensor, got {type(S).__name__}")
    if S.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"{what}: S: expected torch.int16 or torch.int32, got {S.dtype}")
    if S.dim() != 3:
        raise ValueError(f"{what}: S: expected shape (B, L1, L2), got {tuple(S.shape)}")
    if not S.is_contiguous():
        raise ValueError(f"{what}: S: must be contiguous")
    B = S.shape[0]
    sw_cuda._check("l1", l1, torch.int32, (B,), S.device)
    sw_cuda._check("l2", l2, torch.int32, (B,), S.device)


def _launch(what: str, S, l1, l2, go: int, ge: int, local: bool, C: int):
    """One launch on checked CUDA tensors (C 0: the kernel's table); raises
    if it fails."""
    B, L1, L2 = S.shape
    dev = S.device
    if L1 < 1 or L2 < 1 or L1 * L2 >= 2 ** 31:
        raise ValueError(f"{what}: needs 1 <= L1, L2 and L1 * L2 < 2^31, got {L1} x {L2}")
    bits = torch.empty((B, L1, L2), dtype=torch.uint8, device=dev)
    end_i, end_j, score = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(3))
    lib = load()
    n_scratch = lib.dirbits_forward_scratch_ints(B, L1, L2, C)
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dirbits_forward_launch(
            S.data_ptr(), int(S.dtype == torch.int16), l1.data_ptr(), l2.data_ptr(), int(go), int(ge),
            B, L1, L2, int(local), C, bits.data_ptr(), end_i.data_ptr(), end_j.data_ptr(),
            score.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError_t {rc}")
    return bits, end_i, end_j, score


def _counted(what: str, kind: str, S, l1, l2, go: int, ge: int):
    """The launch of a wrapper at the table's C, counted in LAUNCHES and
    SHAPES."""
    out = _launch(what, S, l1, l2, go, ge, kind == "sw_bits", 0)
    if S.shape[0]:
        LAUNCHES[kind] += 1
        shape = tuple(S.shape)
        SHAPES[kind][shape] = SHAPES[kind].get(shape, 0) + 1
    return out


def nw_forward_bits_cuda(
    S: torch.Tensor,   # (B, L1, L2) int16/int32 quantized scores (pad = PAD_SCORE)
    l1: torch.Tensor,  # (B,) int32 true row counts
    l2: torch.Tensor,  # (B,) int32 true col counts
    go: int,
    ge: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The semi-global NW forward (ops/nw_device.py::nw_forward_bits): the
    kernel on a card, the plain version on the CPU."""
    _checked("nw_forward_bits_cuda", S, l1, l2)
    if S.device.type == "cpu":
        return nw_device.nw_forward_bits(S, l1, l2, go, ge)
    if S.device.type != "cuda":
        raise ValueError(f"nw_forward_bits_cuda: unsupported device {S.device}")
    t0 = time.perf_counter()
    out = _counted("nw_forward_bits_cuda", "nw", S, l1, l2, go, ge)
    profiling.add_counter("msa.dispatches", 1)
    profiling.add_counter("msa.nw.seconds", time.perf_counter() - t0)
    return out


def sw_forward_bits_cuda(
    S: torch.Tensor,   # (B, L1, L2) int16/int32 integer scores (pad <= 0)
    l1: torch.Tensor,  # (B,) int32 true row counts
    l2: torch.Tensor,  # (B,) int32 true col counts
    go: int,
    ge: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The local SW forward of the m8 traceback (ops/sw_bits.py::
    sw_forward_bits): the kernel on a card, the plain version on the CPU."""
    _checked("sw_forward_bits_cuda", S, l1, l2)
    if S.device.type == "cpu":
        return sw_bits.sw_forward_bits(S, l1, l2, go, ge)
    if S.device.type != "cuda":
        raise ValueError(f"sw_forward_bits_cuda: unsupported device {S.device}")
    t0 = time.perf_counter()
    out = _counted("sw_forward_bits_cuda", "sw_bits", S, l1, l2, go, ge)
    profiling.add_counter("traceback.dispatches", 1)
    profiling.add_counter("traceback.seconds", time.perf_counter() - t0)
    return out


def forward_bits_columns(
    C: int, S: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor, go: int, ge: int, local: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel at C columns a lane (C of COLUMNS) in place of its
    table's, the NW instance or (`local`) the SW one: CUDA tensors only,
    not counted in LAUNCHES."""
    what = "forward_bits_columns"
    if C not in COLUMNS:
        raise ValueError(f"{what}: C must be one of {COLUMNS}, got {C}")
    _checked(what, S, l1, l2)
    if S.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {S.device}")
    return _launch(what, S, l1, l2, go, ge, local, C)
