"""ctypes bindings of the native host runtime (fastio.cpp).

Counterpart of unicore_tpu/native/__init__.py, on the port's own copy of
fastio.cpp.  The library is compiled at first use with g++ into
`build/unicore_tpu_torch/` beside the package (never into the package),
named by a hash of the source and the flags, so a stale build is never
loaded; `python -m unicore_tpu_torch.native.build` builds it ahead of
time.  A build goes to a temporary file that is renamed into place, so
processes building at once never load a partial library.  Unlike the JAX
package, nothing falls back to Python when the build fails: it raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unicore_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
VERSION = 1  # ufio_version() of fastio.cpp

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native featurizer "
                           f"({SOURCE.name}) cannot be built")
    return cxx


def build_library(source: Optional[Path] = None, flags: Tuple[str, ...] = CXX_FLAGS) -> Path:
    """Compile `source` (default fastio.cpp) with g++ into a shared
    library under BUILD_DIR, named by a hash of the source and the flags;
    returns its path (an existing build is reused)."""
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = Path(BUILD_DIR) / f"libufio_{digest}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        res = subprocess.run([_cxx(), *flags, str(source), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({res.returncode}) on {source}:\n{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def load() -> ctypes.CDLL:
    """Build the library if it is not built yet, load it and declare its
    C interface."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = build_library()
        lib = ctypes.CDLL(str(so))
        lib.ufio_version.argtypes = []
        lib.ufio_version.restype = ctypes.c_int
        if lib.ufio_version() != VERSION:
            raise RuntimeError(f"{so}: ufio_version() {lib.ufio_version()}, the bindings expect {VERSION}")
        lib.ufio_count_fasta.argtypes = [ctypes.c_char_p]
        lib.ufio_count_fasta.restype = ctypes.c_long
        lib.ufio_featurize.argtypes = [
            ctypes.POINTER(ctypes.c_int8),   # codes, concatenated
            ctypes.POINTER(ctypes.c_int64),  # offsets
            ctypes.POINTER(ctypes.c_int32),  # lens
            ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nseq k dim channel
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,             # out nthreads
        ]
        lib.ufio_featurize.restype = ctypes.c_int
        _LIB = lib
        return lib


def count_fasta(path: str) -> int:
    """Number of records ('>' at a line start) in a FASTA file."""
    n = load().ufio_count_fasta(os.fsencode(path))
    if n < 0:
        raise OSError(f"cannot read {path}")
    return n


def featurize_native(code_arrays: Sequence[np.ndarray], k: int, dim: int, channel: int,
                     out: np.ndarray, nthreads: int = 0) -> None:
    """Set the bits of the hashed k-mers of each code array (codes in
    [0, 21)) in the rows of `out` (N, dim) float32, with the hashing of
    align/prefilter.py::_kmer_hashes; `nthreads` <= 0 means
    os.cpu_count() (the result does not depend on it)."""
    n = len(code_arrays)
    if out.dtype != np.float32 or out.shape != (n, dim) or not out.flags.c_contiguous:
        raise ValueError(f"out: expected a C-contiguous float32 array of shape {(n, dim)}")
    if k < 1 or dim < 1:
        raise ValueError(f"k and dim must be >= 1, got {k}, {dim}")
    lib = load()
    codes = [np.asarray(c) for c in code_arrays]
    for c in codes:
        if c.size and (c.min() < 0 or c.max() >= 21):
            raise ValueError("codes must lie in [0, 21)")
    lens = np.array([len(c) for c in codes], dtype=np.int32)
    offsets = np.zeros(n, dtype=np.int64)
    if n > 1:
        offsets[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    concat = np.concatenate([c.astype(np.int8) for c in codes]) if n else np.zeros(0, np.int8)
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    lib.ufio_featurize(
        concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, k, dim, channel,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nthreads,
    )
