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
source and the flags, and loaded with ctypes.  Rows wider than the kernel's
tile of 4,096 columns keep their H and F in a scratch tensor that the
wrapper allocates (`dirbits_forward_scratch_ints`).

On the card the wrappers add the counters the plain versions add, with the
same meaning per call: `msa.dispatches` and `msa.nw.seconds`, or
`traceback.dispatches` and `traceback.seconds` (the host wall time of the
call; the waits for the results are counted where they are collected).

`LAUNCHES` counts the launches per instance ("nw", "sw_bits"), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from unicore_tpu_torch.ops import nw_device, sw_bits, sw_cuda
from unicore_tpu_torch.runtime import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dirbits.cu"

LAUNCHES: Dict[str, int] = {"nw": 0, "sw_bits": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(so: Path) -> ctypes.CDLL:
    """Load a library built from csrc/dirbits.cu and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.dirbits_forward_launch.argtypes = [
        _P, _I, _P, _P, _I, _I,  # S s_int16 l1 l2 go ge
        _I, _I, _I, _I,          # B L1 L2 local
        _P, _P, _P, _P, _P, _P,  # bits end_i end_j score scratch stream
    ]
    lib.dirbits_forward_launch.restype = ctypes.c_int
    lib.dirbits_forward_scratch_ints.argtypes = [_I, _I]
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


def _launch(what: str, kind: str, S, l1, l2, go: int, ge: int, local: bool):
    B, L1, L2 = S.shape
    dev = S.device
    if L1 < 1 or L2 < 1 or L1 * L2 >= 2 ** 31:
        raise ValueError(f"{what}: needs 1 <= L1, L2 and L1 * L2 < 2^31, got {L1} x {L2}")
    bits = torch.empty((B, L1, L2), dtype=torch.uint8, device=dev)
    end_i, end_j, score = (torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(3))
    lib = load()
    n_scratch = lib.dirbits_forward_scratch_ints(B, L2)
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dirbits_forward_launch(
            S.data_ptr(), int(S.dtype == torch.int16), l1.data_ptr(), l2.data_ptr(), int(go), int(ge),
            B, L1, L2, int(local), bits.data_ptr(), end_i.data_ptr(), end_j.data_ptr(),
            score.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError_t {rc}")
    if B:
        LAUNCHES[kind] += 1
    return bits, end_i, end_j, score


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
    out = _launch("nw_forward_bits_cuda", "nw", S, l1, l2, go, ge, local=False)
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
    out = _launch("sw_forward_bits_cuda", "sw_bits", S, l1, l2, go, ge, local=True)
    profiling.add_counter("traceback.dispatches", 1)
    profiling.add_counter("traceback.seconds", time.perf_counter() - t0)
    return out
