"""Wrapper of the Hopper banded Smith-Waterman kernel (`csrc/banded.cu`).

`sw_forward_banded_cuda` takes the inputs of ops/banded.py::sw_forward_banded
(unicore_tpu.ops.banded.sw_forward_banded) and returns (best f32, qend i32,
tend i32) per pair.  On CUDA tensors it launches the kernel on the current
stream, without synchronising, or raises; on CPU tensors it runs the plain
version.  There is no fallback from one to the other.

The kernel is compiled at first use by `nvcc` for sm_90a with
ops/sw_cuda.py's flags (`sw_cuda.build_library`) into a shared library
with a plain C interface under `build/unicore_tpu_torch/`, keyed by a hash
of the source and the flags, as three translation units (gapped with and
without the bias, ungapped) by three nvcc processes at once (`PARTS`), and
loaded with ctypes.  It takes bands of up
to MAX_W columns, and any Lq and Lt: it stages the codes of STAGE_ROWS rows
at a time in shared memory, one pair a block.  `columns_of` reads the
kernel's table of columns a lane (C) per band width;
`sw_forward_banded_columns` launches it at another C, for the sweep of
chip_smoke.py phase 3e and the card's tests.

`LAUNCHES` counts the launches per mode ("gapped", "ungapped"), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from unicore_tpu_torch.ops import sw_cuda
from unicore_tpu_torch.ops.banded import sw_forward_banded
from unicore_tpu_torch.ops.sw import NA

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "banded.cu"
MAX_W = 8192  # banded.cu: MAX_W
STAGE_ROWS = 2048  # banded.cu: STAGE_ROWS
MAX_THREADS = 512  # banded.cu: MAXT, threads a block
PARTS = 3  # banded.cu's translation units (its TU_PART values), built at once
COLUMNS = (1, 2, 4, 8, 16)  # the kernel's columns a lane (C)

LAUNCHES: Dict[str, int] = {"gapped": 0, "ungapped": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(so: Path) -> ctypes.CDLL:
    """Load a library built from csrc/banded.cu and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.banded_forward_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # qa qs ta ts qlen tlen d0 qc saa s3d
        _F, _F, _F, _F,                          # go ge w_aa w_3di
        _I, _I, _I, _I, _I, _I, _I,              # B Lq Lt W gap_window ungapped C
        _P, _P, _P, _P,                          # best qend tend stream
    ]
    lib.banded_forward_launch.restype = ctypes.c_int
    lib.banded_forward_columns.argtypes = [_I, _I]
    lib.banded_forward_columns.restype = ctypes.c_int
    lib.banded_forward_max_w.restype = ctypes.c_int
    lib.banded_forward_stage_rows.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build the kernel's library if it is not built yet, and load it."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = sw_cuda.build_library(source=SOURCE, parts=PARTS)
        lib = bind(so)
        if (lib.banded_forward_max_w(), lib.banded_forward_stage_rows()) != (MAX_W, STAGE_ROWS):
            raise RuntimeError(f"{so}: kernel takes W <= {lib.banded_forward_max_w()} and stages "
                               f"{lib.banded_forward_stage_rows()} rows, the wrapper expects {MAX_W} "
                               f"and {STAGE_ROWS}")
        _LIB = lib
        return lib


def build() -> float:
    """Build (if needed) and load the kernel; returns the seconds taken."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def columns_of(W: int, ungapped: bool) -> int:
    """The kernel's table: columns a lane for a band of W columns in a
    mode (builds the kernel if needed)."""
    return load().banded_forward_columns(int(W), int(bool(ungapped)))


def _check(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, gap_window, qc) -> None:
    B, Lq = qa.shape
    Lt = ta.shape[1]
    dev = qa.device
    check = sw_cuda._check
    for name, t, shape in (("qa", qa, (B, Lq)), ("qs", qs, (B, Lq)),
                           ("ta", ta, (B, Lt)), ("ts", ts, (B, Lt)),
                           ("qlen", qlen, (B,)), ("tlen", tlen, (B,)), ("d0", d0, (B,))):
        check(name, t, torch.int32, shape, dev)
    check("saa", saa, torch.float32, (NA, NA), dev)
    check("s3d", s3d, torch.float32, (NA, NA), dev)
    if qc is not None:
        check("qc", qc, torch.int32, (B, Lq), dev)
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    if gap_window < 0:
        raise ValueError(f"gap_window must be >= 0, got {gap_window}")


def _launch(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, go, ge, w_aa, w_3di, gap_window,
            ungapped, qc, C) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch on checked CUDA tensors at C columns a lane (0: the
    kernel's table); raises if it fails."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    dev = qa.device
    if dev.type != "cuda":
        raise ValueError(f"sw_forward_banded_cuda: unsupported device {dev}")
    if W > MAX_W:
        raise ValueError(f"sw_forward_banded_cuda: the kernel takes bands of W <= {MAX_W} "
                         f"columns, got W = {W}")
    if Lq < 1 or Lt < 1:
        raise ValueError(f"sw_forward_banded_cuda: needs Lq >= 1 and Lt >= 1, got {Lq}, {Lt}")

    best = torch.empty((B,), dtype=torch.float32, device=dev)
    qend = torch.empty((B,), dtype=torch.int32, device=dev)
    tend = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.banded_forward_launch(
            qa.data_ptr(), qs.data_ptr(), ta.data_ptr(), ts.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), d0.data_ptr(),
            None if qc is None else qc.data_ptr(),
            saa.data_ptr(), s3d.data_ptr(),
            float(go), float(ge), float(w_aa), float(w_3di),
            B, Lq, Lt, int(W), int(gap_window), int(bool(ungapped)), int(C),
            best.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_forward_banded_cuda: kernel launch failed, cudaError_t {rc}")
    return best, qend, tend


def sw_forward_banded_cuda(
    qa: torch.Tensor,    # (B, Lq) int32 AA codes (pad with X=20)
    qs: torch.Tensor,    # (B, Lq) int32 3Di codes
    ta: torch.Tensor,    # (B, Lt) int32
    ts: torch.Tensor,    # (B, Lt) int32
    qlen: torch.Tensor,  # (B,) int32
    tlen: torch.Tensor,  # (B,) int32
    d0: torch.Tensor,    # (B,) int32 seed diagonal (t_pos - q_pos)
    saa: torch.Tensor,   # (21, 21) float32
    s3d: torch.Tensor,   # (21, 21) float32
    W: int = 256,
    go: float = 100.0,
    ge: float = 10.0,
    w_aa: float = 4.0,
    w_3di: float = 6.0,
    gap_window: int = 0,
    ungapped: bool = False,
    qc: Optional[torch.Tensor] = None,  # (B, Lq) int32 per-query-row correction
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, qend, tend) per pair over the band j in [i+d0-W/2, i+d0+W/2);
    see the module docstring."""
    _check(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, gap_window, qc)
    if qa.device.type == "cpu":
        return sw_forward_banded(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W=W, go=go, ge=ge,
                                 w_aa=w_aa, w_3di=w_3di, gap_window=gap_window,
                                 ungapped=ungapped, qc=qc)
    res = _launch(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, go, ge, w_aa, w_3di, gap_window,
                  ungapped, qc, 0)
    if qa.shape[0]:
        LAUNCHES["ungapped" if ungapped else "gapped"] += 1
    return res


def sw_forward_banded_columns(
    C: int, qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W: int = 256, go: float = 100.0,
    ge: float = 10.0, w_aa: float = 4.0, w_3di: float = 6.0, gap_window: int = 0,
    ungapped: bool = False, qc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel at C columns a lane in place of its table's (C of
    COLUMNS; a pair of W columns takes ceil(W / 32C) warps, at most
    MAX_THREADS / 32): CUDA tensors only, not counted in LAUNCHES."""
    if C not in COLUMNS:
        raise ValueError(f"sw_forward_banded_columns: C must be one of {COLUMNS}, got {C}")
    _check(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, gap_window, qc)
    return _launch(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, go, ge, w_aa, w_3di, gap_window,
                   ungapped, qc, C)
