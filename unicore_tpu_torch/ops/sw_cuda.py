"""Wrapper of the Hopper Smith-Waterman kernel (`csrc/sw.cu`).

`sw_forward_cuda` takes the inputs of unicore_tpu.ops.sw.sw_forward_pallas
and returns (best f32, qend i32, tend i32) per pair.  On CUDA tensors it
launches the kernel, or raises; on CPU tensors it runs the plain version
(`ops/sw.py::sw_forward_plain`).  There is no fallback from one to the
other.  `dp_dtype="i16"` selects the kernel's int16 instance and the
plain int16 DP (`ops/sw.py::sw_forward_i16`), after the int16 contract
(`ops/sw.py::i16_contract`) is checked on either device.

The kernel is compiled at first use by `nvcc` for sm_90a into a shared
library with a plain C interface, loaded with ctypes, and cached under
`build/unicore_tpu_torch/` beside the package, keyed by a hash of the
source and the flags; its four sets of instances (float32 and int16,
each with and without the bias) compile as translation units of their
own, by four nvcc processes at once (`SW_PARTS`).  The module imports
without a CUDA
toolkit; only the first launch needs one.

`sw_forward_sharded` runs a pair batch data-parallel over a device mesh
(parallel/mesh.py): one block of pairs per device, each through
`sw_forward_cuda` on its device.

`LAUNCHES` counts the launches per mode ("gapped", "ungapped"), so a run
can show that its main path went through the kernel; `SHARDED_LAUNCHES`
counts those of them made through `sw_forward_sharded`, and
`I16_LAUNCHES` those of the int16 instance ("gapped_i16",
"ungapped_i16"), which the main path never takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from unicore_tpu_torch.ops.sw import (
    DP_DTYPES, GAP_EXTEND_INT, GAP_OPEN_INT, NA, W_3DI_INT, W_AA_INT, i16_contract, i16_pad_value,
    sw_forward_plain,
)
from unicore_tpu_torch.parallel.mesh import gather, on_device, shard, shard_devices

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sw.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unicore_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
MAX_LT = 4096  # sw.cu: MAX_PAIR_WARPS * 32 * MAX_C
SW_PARTS = 4  # sw.cu's translation units (its TU_PART values), built at once

LAUNCHES: Dict[str, int] = {"gapped": 0, "ungapped": 0}
# launches made through sw_forward_sharded (also counted in LAUNCHES)
SHARDED_LAUNCHES: Dict[str, int] = {"gapped": 0, "ungapped": 0}
# launches of the int16 instance (dp_dtype="i16"), counted apart from LAUNCHES
I16_LAUNCHES: Dict[str, int] = {"gapped_i16": 0, "ungapped_i16": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, SHARDED_LAUNCHES, I16_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the SW kernel cannot be built")


def _run_nvcc(args) -> None:
    res = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")


def build_library(source: Path = SOURCE, flags: Tuple[str, ...] = NVCC_FLAGS, parts: int = 1) -> Path:
    """Compile `source` with nvcc into a shared library under BUILD_DIR,
    named by the source's stem and a hash of the source, the flags and
    `parts`; returns its path (an existing build is reused).  With parts
    > 1 the source is compiled as that many translation units, -DTU_PART=1
    .. parts, by as many nvcc processes at once, and their objects linked
    into the library: a source that reads TU_PART builds each of its
    instances in one of them."""
    key = Path(source).read_bytes() + " ".join(flags).encode() + (f" parts={parts}".encode() if parts > 1 else b"")
    so = BUILD_DIR / f"lib{Path(source).stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            if parts == 1:
                _run_nvcc([*flags, "-o", tmp, str(source)])
            else:
                with tempfile.TemporaryDirectory(dir=so.parent) as objs, ThreadPoolExecutor(parts) as pool:
                    compile_flags = [f for f in flags if f != "-shared"]
                    names = [os.path.join(objs, f"part{k}.o") for k in range(1, parts + 1)]
                    list(pool.map(lambda k: _run_nvcc([*compile_flags, f"-DTU_PART={k}", "-c", "-o",
                                                       names[k - 1], str(source)]), range(1, parts + 1)))
                    _run_nvcc([*flags, "-o", tmp, *names])
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def bind(so: Path) -> ctypes.CDLL:
    """Load a library built from csrc/sw.cu and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.sw_forward_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # qa qs ta ts qlen tlen qc saa s3d
        _F, _F, _F, _F,                      # go ge w_aa w_3di
        _I, _I, _I, _I, _I,                  # B Lq Lt scan_limit ungapped
        _P, _P, _P, _P,                      # best qend tend stream
    ]
    lib.sw_forward_launch.restype = ctypes.c_int
    lib.sw_forward_max_lt.restype = ctypes.c_int
    if hasattr(lib, "sw_forward_i16_launch"):  # sources before the int16 instance lack it
        lib.sw_forward_i16_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P,  # qa qs ta ts qlen tlen qc saa s3d
            _I, _I, _F, _F, _I,                  # go ge w_aa w_3di pad_v
            _I, _I, _I, _I, _I,                  # B Lq Lt scan_limit ungapped
            _P, _P, _P, _P,                      # best qend tend stream
        ]
        lib.sw_forward_i16_launch.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build the kernel's library if it is not built yet, and load it."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = build_library(parts=SW_PARTS)
        lib = bind(so)
        if lib.sw_forward_max_lt() != MAX_LT:
            raise RuntimeError(f"{so}: kernel takes Lt <= {lib.sw_forward_max_lt()}, "
                               f"the wrapper expects {MAX_LT}")
        _LIB = lib
        return lib


def build() -> float:
    """Build (if needed) and load the kernel; returns the seconds taken."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def scan_limit(Lt: int, gap_window: int) -> int:
    """Upper end of the scan steps d = 1, 2, 4, ... < limit (ops/sw.py::_prefix_max)."""
    return Lt if not gap_window else min(Lt, gap_window)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def sw_forward_cuda(
    qa: torch.Tensor,    # (B, Lq) int32 AA codes in [0, 21)
    qs: torch.Tensor,    # (B, Lq) int32 3Di codes
    ta: torch.Tensor,    # (B, Lt) int32
    ts: torch.Tensor,    # (B, Lt) int32
    qlen: torch.Tensor,  # (B,) int32
    tlen: torch.Tensor,  # (B,) int32
    saa: torch.Tensor,   # (21, 21) float32
    s3d: torch.Tensor,   # (21, 21) float32
    go: float = GAP_OPEN_INT,
    ge: float = GAP_EXTEND_INT,
    w_aa: float = W_AA_INT,
    w_3di: float = W_3DI_INT,
    gap_window: int = 0,
    ungapped: bool = False,
    qc: Optional[torch.Tensor] = None,  # (B, Lq) int32 per-query-row correction
    dp_dtype: str = "f32",  # "f32" | "i16": sw_forward_pallas's DP state type
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, qend, tend) per pair; see the module docstring."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    dev = qa.device
    for name, t, shape in (("qa", qa, (B, Lq)), ("qs", qs, (B, Lq)),
                           ("ta", ta, (B, Lt)), ("ts", ts, (B, Lt)),
                           ("qlen", qlen, (B,)), ("tlen", tlen, (B,))):
        _check(name, t, torch.int32, shape, dev)
    _check("saa", saa, torch.float32, (NA, NA), dev)
    _check("s3d", s3d, torch.float32, (NA, NA), dev)
    if qc is not None:
        _check("qc", qc, torch.int32, (B, Lq), dev)
    if gap_window < 0:
        raise ValueError(f"gap_window must be >= 0, got {gap_window}")
    if dp_dtype not in DP_DTYPES:
        raise ValueError(f"dp_dtype must be one of {DP_DTYPES}, got {dp_dtype!r}")
    if dp_dtype == "i16":
        i16_contract(Lq, Lt, go, ge, w_aa, w_3di)

    if dev.type == "cpu":
        return sw_forward_plain(qa, qs, ta, ts, qlen, tlen, saa, s3d,
                                go=go, ge=ge, w_aa=w_aa, w_3di=w_3di,
                                gap_window=gap_window, ungapped=ungapped, qc=qc,
                                dp_dtype=dp_dtype)
    if dev.type != "cuda":
        raise ValueError(f"sw_forward_cuda: unsupported device {dev}")
    if Lq < 1 or not 1 <= Lt <= MAX_LT:
        raise ValueError(f"sw_forward_cuda: needs Lq >= 1 and 1 <= Lt <= {MAX_LT}, got {Lq}, {Lt}")

    out = launch_with(load(), qa, qs, ta, ts, qlen, tlen, saa, s3d, go, ge, w_aa, w_3di,
                      gap_window, ungapped, qc, dp_dtype)
    if B and dp_dtype == "i16":
        I16_LAUNCHES["ungapped_i16" if ungapped else "gapped_i16"] += 1
    elif B:
        LAUNCHES["ungapped" if ungapped else "gapped"] += 1
    return out


def sw_forward_sharded(
    qa, qs, ta, ts, qlen, tlen,  # arrays or tensors: (B, Lq), (B, Lq), (B, Lt), (B, Lt), (B,), (B,)
    saa, s3d,                    # (21, 21): arrays, tensors or parallel.mesh.Replicas
    mesh,
    go: float = GAP_OPEN_INT,
    ge: float = GAP_EXTEND_INT,
    w_aa: float = W_AA_INT,
    w_3di: float = W_3DI_INT,
    ungapped: bool = False,
    gap_window: int = 0,
    qc=None,                     # (B, Lq) or None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`sw_forward_cuda` data-parallel over the devices of `mesh`'s first
    axis (unicore_tpu.ops.sw.sw_forward_sharded): the pair batch is split
    into one block of rows per device, the matrices are replicated, and
    each block goes through `sw_forward_cuda` on its device (the kernel
    on a card, the plain version on the CPU).  Pairs are independent, so
    the results are bit-identical to one call on the whole batch.

    B must be a multiple of the number of shards (align/engine.py pads).
    Every shard is launched before any is read; (best, qend, tend) come
    back in input order on the first shard's device, not yet
    synchronised.  SHARDED_LAUNCHES counts the launches on a card."""
    devices = shard_devices(mesh)
    blocks = [shard(x, devices, torch.int32) for x in (qa, qs, ta, ts, qlen, tlen)]
    qcs = [None] * len(devices) if qc is None else shard(qc, devices, torch.int32)
    outs = []
    for k, dev in enumerate(devices):
        outs.append(sw_forward_cuda(
            *(b[k] for b in blocks), on_device(saa, dev).float(), on_device(s3d, dev).float(),
            go=go, ge=ge, w_aa=w_aa, w_3di=w_3di, gap_window=gap_window, ungapped=ungapped,
            qc=qcs[k]))
        if dev.type == "cuda" and outs[-1][0].numel():
            SHARDED_LAUNCHES["ungapped" if ungapped else "gapped"] += 1
    return tuple(gather([o[i] for o in outs], devices[0]) for i in range(3))


def launch_with(lib: ctypes.CDLL, qa, qs, ta, ts, qlen, tlen, saa, s3d, go, ge, w_aa, w_3di,
                gap_window, ungapped, qc, dp_dtype: str = "f32",
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch `lib`'s kernel (its int16 instance with dp_dtype="i16", on
    inputs inside the int16 contract) on checked CUDA tensors
    (sw_forward_cuda's inputs) on the current stream; raises if the launch
    fails."""
    B, Lq = qa.shape
    Lt = ta.shape[1]
    dev = qa.device
    best = torch.empty((B,), dtype=torch.float32, device=dev)
    qend = torch.empty((B,), dtype=torch.int32, device=dev)
    tend = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (qa.data_ptr(), qs.data_ptr(), ta.data_ptr(), ts.data_ptr(),
                qlen.data_ptr(), tlen.data_ptr(), None if qc is None else qc.data_ptr(),
                saa.data_ptr(), s3d.data_ptr())
        tail = (B, Lq, Lt, scan_limit(Lt, gap_window), int(bool(ungapped)),
                best.data_ptr(), qend.data_ptr(), tend.data_ptr(), stream)
        if dp_dtype == "i16":
            rc = lib.sw_forward_i16_launch(*head, int(go), int(ge), float(w_aa), float(w_3di),
                                           i16_pad_value(w_aa, w_3di), *tail)
        else:
            rc = lib.sw_forward_launch(*head, float(go), float(ge), float(w_aa), float(w_3di), *tail)
    if rc != 0:
        raise RuntimeError(f"sw_forward_cuda: kernel launch failed, cudaError_t {rc}")
    return best, qend, tend

