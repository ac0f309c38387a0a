"""unicore_tpu_torch — the PyTorch/CUDA port of unicore_tpu.

A second implementation of the unicore_tpu pipeline (structural core-gene
phylogeny: proteomes -> 3Di strings -> structural clusters -> single-copy
core genes -> ...) written in PyTorch for one NVIDIA H100.  The JAX
package `unicore_tpu` stays the reference: every ported stage writes the
same files, byte for byte, on the same inputs.

Rules of the port:
- it imports `torch`, never `jax`, and nothing of `unicore_tpu`; the
  host modules it needs (alphabets, matrices, io, runtime, ...) are its
  own copies;
- the module layout and names follow `unicore_tpu`, so each counterpart
  is found at the same path;
- the one Pallas kernel of the JAX package (`ops/sw.py::_sw_kernel`) is a
  CUDA C++ kernel written for Hopper (`csrc/sw.cu`, wrapped by
  `ops/sw_cuda.py`); plain PyTorch versions of it stay beside it as the
  CPU path and the reference it is held against;
- entry points run on CUDA unless the caller asks for the CPU
  (`UNICORE_TPU_TORCH_DEVICE=cpu`, see `runtime/device.py`).

Every module of `unicore_tpu` has its counterpart: the ten subcommands,
the multi-device paths (`parallel/`), ProstT5 inference and training with
tensor, sequence and data parallelism over one process's mesh
(`parallel/sharding.py`), and `graft_entry.py` for `__graft_entry__.py`.
"""

__version__ = "0.1.0"

CITATION = (
    "Kim, D., Park, S. & Steinegger, M. Unicore enables scalable and accurate "
    "phylogenetic reconstruction with structural core genes. "
    "Genome Biology and Evolution (2025). (reference pipeline)\n"
    "unicore_tpu_torch: PyTorch/CUDA re-implementation."
)
