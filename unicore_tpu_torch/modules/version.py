"""version banner (modules/version.rs:4-18)."""

from __future__ import annotations

import unicore_tpu_torch

LOGO = r"""
 __  __     __   __     __     ______     ______     ______     ______
/\ \/\ \   /\ "-.\ \   /\ \   /\  ___\   /\  __ \   /\  == \   /\  ___\
\ \ \_\ \  \ \ \-.  \  \ \ \  \ \ \____  \ \ \/\ \  \ \  __<   \ \  __\
 \ \_____\  \ \_\\"\_\  \ \_\  \ \_____\  \ \_____\  \ \_\ \_\  \ \_____\
  \/_____/   \/_/ \/_/   \/_/   \/_____/   \/_____/   \/_/ /_/   \/_____/
                                                        PyTorch/CUDA edition
"""


def run() -> None:
    print(LOGO)
    print(f"unicore-tpu-torch version {unicore_tpu_torch.__version__}")
    print()
    print(unicore_tpu_torch.CITATION)
