"""What the harness and the reference load: never JAX, flax or the JAX
package (`unicore_tpu`, compared whole: `unicore_tpu_torch` is another
name), and the reference nothing of the program."""

import json
import subprocess
import sys

from port_bench.harness import ROOT

BANNED = {"jax", "jaxlib", "flax", "unicore_tpu"}

HARNESS_RUN = """
import json, os, sys, time
sys.path.insert(0, {root!r})
from port_bench import harness
spec = harness.load_spec()
cfg = harness.load_json(os.path.join({root!r}, "port_bench/tests/data/tiny-createdb.json"))
for cell in ("createdb.bacteria", "createdb.eukaryote"):
    for trace in (False, True):
        harness.run_cell(spec, cell, 9, 0.2, trace, "cpu", time.perf_counter(), cfg=cfg)
for name in [n for n in os.listdir(os.path.join({root!r}, "port_bench", "metrics")) if n.endswith(".py")]:
    harness.load_module(os.path.join(harness.HERE, "metrics", name), "m_" + name[:-3])
import port_bench.control, port_bench.run
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import port_bench.reference.prostt5
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def loaded(code):
    p = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True, text=True,
                       timeout=600, env={"UNICORE_TPU_TORCH_DEVICE": "cpu", "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = loaded(HARNESS_RUN)
    assert "unicore_tpu_torch" in tops and "port_bench" in tops
    assert not tops & BANNED, tops & BANNED


def test_reference_loads_nothing_of_the_program():
    tops = loaded(REFERENCE)
    assert not tops & (BANNED | {"unicore_tpu_torch"}), tops


def test_banned_names_compared_whole(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "unicore_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not set(harness.banned_modules()) & {"unicore_tpu_torch_extra", "jaxtyping"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.banned_modules()
