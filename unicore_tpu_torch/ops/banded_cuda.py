"""Wrapper of the Hopper banded Smith-Waterman kernel (`csrc/banded.cu`).

`sw_forward_banded_cuda` takes the inputs of ops/banded.py::sw_forward_banded
(unicore_tpu.ops.banded.sw_forward_banded) and returns (best f32, qend i32,
tend i32) per pair.  On CUDA tensors it launches the kernel on the current
stream, without synchronising, or raises; on CPU tensors it runs the plain
version.  There is no fallback from one to the other.

The kernel is compiled at first use by `nvcc` for sm_90a with
ops/sw_cuda.py's flags (`sw_cuda.build_library`) into a shared library
with a plain C interface under `build/unicore_tpu_torch/`, keyed by a hash
of the source and the flags, and loaded with ctypes.  It takes bands of up
to MAX_W columns.

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
        _I, _I, _I, _I, _I, _I,                  # B Lq Lt W gap_window ungapped
        _P, _P, _P, _P,                          # best qend tend stream
    ]
    lib.banded_forward_launch.restype = ctypes.c_int
    lib.banded_forward_max_w.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build the kernel's library if it is not built yet, and load it."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = sw_cuda.build_library(source=SOURCE)
        lib = bind(so)
        if lib.banded_forward_max_w() != MAX_W:
            raise RuntimeError(f"{so}: kernel takes W <= {lib.banded_forward_max_w()}, "
                               f"the wrapper expects {MAX_W}")
        _LIB = lib
        return lib


def build() -> float:
    """Build (if needed) and load the kernel; returns the seconds taken."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


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

    if dev.type == "cpu":
        return sw_forward_banded(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W=W, go=go, ge=ge,
                                 w_aa=w_aa, w_3di=w_3di, gap_window=gap_window,
                                 ungapped=ungapped, qc=qc)
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
            B, Lq, Lt, int(W), int(gap_window), int(bool(ungapped)),
            best.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_forward_banded_cuda: kernel launch failed, cudaError_t {rc}")
    if B:
        LAUNCHES["ungapped" if ungapped else "gapped"] += 1
    return best, qend, tend
