"""The port's int16 probe (scripts/torch_probe_i16.py) against the JAX
package's (scripts/probe_i16.py): the same probe names, and the port's
numpy reference equal to JAX's own probe kernel run with
`pl.pallas_call(..., interpret=True)` on the CPU, on both input sets.  The
kernels themselves run only on a card (tests/test_torch_sw_i16_cuda.py)."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_probe_i16.py")


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = load(SCRIPT, "torch_probe_i16")
JAX = load(os.path.join(REPO, "scripts", "probe_i16.py"), "probe_i16")


def test_probe_names_cover_jax():
    assert list(PORT.PROBES)[:len(JAX.PROBES)] == list(JAX.PROBES)


def jax_probe(expr, x, y):
    """scripts/probe_i16.py's CHILD kernel, interpreted on the CPU."""
    scope = dict(jnp=jnp, pltpu=pltpu)

    def kernel(x_ref, y_ref, o_ref):
        o_ref[:] = eval(expr, scope, dict(x=x_ref[:], y=y_ref[:]))

    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int16),
                         interpret=True)(jnp.asarray(x), jnp.asarray(y))
    return np.asarray(out)


@pytest.mark.parametrize("name", list(JAX.PROBES))
def test_reference_equals_jax_probe_kernel(name):
    for set_name, (x, y, z) in PORT.inputs().items():
        want = jax_probe(JAX.PROBES[name], x, y)
        got = PORT.reference(name, x, y, z)
        assert got.dtype == want.dtype == np.int16, set_name
        assert np.array_equal(got, want), set_name


def test_inputs_reach_the_int16_ends():
    x, y, z = PORT.inputs()["random"]
    assert x.max() == 32767 and x.min() == -32768
    # the random set makes each wrapping probe wrap somewhere
    wide = x.astype(np.int32)
    assert ((wide + y > 32767) | (wide + y < -32768)).any()
    assert ((wide - y > 32767) | (wide - y < -32768)).any()
    x1, y1, _ = PORT.inputs()["ones_twos"]
    assert (x1 == 1).all() and (y1 == 2).all()


def test_script_without_nvcc_or_card_exits_2():
    """Where nvcc or the card is missing, the script names what is
    missing, runs nothing and exits 2."""
    import torch

    from unicore_tpu_torch.ops import sw_cuda

    try:
        sw_cuda._nvcc()
        has_nvcc = True
    except RuntimeError:
        has_nvcc = False
    if has_nvcc and torch.cuda.is_available():
        pytest.skip("nvcc and a card are both here: tests/test_torch_sw_i16_cuda.py runs the probes")
    r = subprocess.run([sys.executable, SCRIPT], capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
    assert ("no nvcc" in r.stderr) == (not has_nvcc)
    assert ("no card" in r.stderr) == (not torch.cuda.is_available())
    assert "nothing was run" in r.stderr and "compile and match" not in r.stdout
