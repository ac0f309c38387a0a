"""Device selection: the one place that decides where the port runs.

Entry points run on CUDA.  The CPU is used only when the caller asks for
it, through `UNICORE_TPU_TORCH_DEVICE=cpu` (the port's counterpart of
`JAX_PLATFORMS=cpu`) or an explicit `device=` argument.  Asking for CUDA
where there is none is an error: the port never carries on quietly on
the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from . import errors as err

ENV = "UNICORE_TPU_TORCH_DEVICE"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, else $UNICORE_TPU_TORCH_DEVICE, else "cuda"; checked."""
    dev = torch.device(device if device is not None else os.environ.get(ENV) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        err.error(
            err.ERR_GENERAL,
            f"CUDA was asked for ({ENV}={os.environ.get(ENV) or 'unset'}) but "
            f"torch.cuda.is_available() is False; set {ENV}=cpu to run on the CPU",
        )
    if dev.type not in ("cuda", "cpu"):
        err.error(err.ERR_GENERAL, f"unsupported device {dev}")
    return dev
