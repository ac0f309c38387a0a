"""Shared fixtures of the harness's CPU tests: the repository root on
sys.path, the CPU as the program's device, and the tiny configuration
that stands in for a cell's own."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["UNICORE_TPU_TORCH_DEVICE"] = "cpu"


@pytest.fixture
def tiny_cfg():
    from port_bench import harness

    return harness.load_json(os.path.join(DATA, "tiny-createdb.json"))


@pytest.fixture
def spec():
    from port_bench import harness

    return harness.load_spec()


@pytest.fixture
def need_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
