"""The CPU likelihood against the process state that chip_smoke.py's
phases leave before phase 3c: `LikelihoodEngine.loglik_batch` must give a
clean process's value, bit for bit, after the CPU work of those phases,
under the matmul precisions a caller may request and at more intra-op
threads than cores; the clean value agrees with JAX's engine (rtol 1e-5,
tests/test_torch_phylo.py's tolerance) and with the float64 arbiter of
phase 3c (1e-6 relative).  Also scripts/torch_phylo_repro.py and
scripts/torch_phylo_perturb.py on a small size without JAX, and
chip_smoke.OpenMPTeam's reading of the OpenMP workers.  Small inputs: 8
taxa x 600 columns, 8 candidates."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TAXA, N_COLUMNS, SEED, K = 8, 600, 5, 8
MODEL, ALPHA, P_INV = "JTT+F+I+G", 0.7, 0.05


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    """(msa, CPU engine, cb, bb): phase 3c's construction at a small size."""
    from unicore_tpu_torch.phylo import likelihood as tl
    from unicore_tpu_torch.phylo import search as ts
    from unicore_tpu_torch.synthetic import simulate_msa

    c = _chip_smoke()
    rng = np.random.RandomState(SEED)
    msa = simulate_msa(rng, N_TAXA, N_COLUMNS)
    cpu, _ = c._phylo_pair(msa, MODEL, ALPHA, P_INV, "cpu")
    children, blens = c._nj_start(msa, 1e-3)
    root = tl.arrays_to_tree(children, blens, cpu.names)
    trees = ts.nni_neighbors(root)
    while len(trees) < K:
        trees.append(ts.random_nni_walk(root, rng, 3))
    arr = [tl.tree_to_arrays(x, cpu.names) for x in trees[:K]]
    return msa, cpu, np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])


_CLEAN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from test_torch_phylo_state import _inputs
_, cpu, cb, bb = _inputs()
print(json.dumps([float(x) for x in cpu.loglik_batch(cb, bb)]))
"""


@pytest.fixture(scope="module")
def clean():
    """loglik_batch's values from a fresh process that did nothing else."""
    env = dict(os.environ, UNICORE_TPU_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", _CLEAN, REPO, os.path.join(REPO, "tests")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return np.array(json.loads(res.stdout.strip().splitlines()[-1]), np.float32)


def _phase_3b_cpu_work():
    """Phase 3b's CPU side: the plain NW forward on CPU tensors, the merge's
    float64 count products and the guide tree's float32 gram."""
    from unicore_tpu_torch.msa.guide_tree import _shared_counts
    from unicore_tpu_torch.ops.nw_device import _count_scores, nw_forward_bits
    from unicore_tpu_torch.synthetic import nw_scores

    rng = np.random.RandomState(1)
    S, l1, l2 = nw_scores(rng, 4, 64, 60, "rand")
    nw_forward_bits(*[torch.from_numpy(x) for x in (S, l1, l2)], 2816, 256)
    mats = [torch.from_numpy(np.eye(32) * 3.0) for _ in range(2)]
    counts = [torch.from_numpy(rng.randint(0, 6, (4, 64, 32)).astype(np.int16)) for _ in range(4)]
    n = torch.full((4,), 5, dtype=torch.int32)
    lens = torch.from_numpy(rng.randint(1, 65, 4).astype(np.int32))
    _count_scores(*counts, n, n, lens, lens.flip(0), *mats, 14, 21)
    _shared_counts((rng.rand(256, 1024) < 0.05).astype(np.int8), "cpu")


class _Precision:
    def __init__(self, p):
        self.p = p

    def __enter__(self):
        self.prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(self.p)

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.prev)


class _Threads:
    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.prev = torch.get_num_threads()
        torch.set_num_threads(self.n)

    def __exit__(self, *exc):
        torch.set_num_threads(self.prev)


@pytest.mark.parametrize("state", ["phase 3b's CPU work", "TF32 requested", "bf16 requested",
                                   "twice the cores in threads", "a float64 pass first"])
def test_loglik_batch_equals_a_clean_process(clean, state, monkeypatch):
    """Bit for bit: the state must not reach the likelihood's value."""
    monkeypatch.setenv("UNICORE_TPU_TORCH_DEVICE", "cpu")
    _, cpu, cb, bb = _inputs()
    if state == "phase 3b's CPU work":
        _phase_3b_cpu_work()
        ctx = _Precision(torch.get_float32_matmul_precision())
    elif state == "a float64 pass first":
        _chip_smoke().float64_loglik(cpu, cb, bb)
        ctx = _Precision(torch.get_float32_matmul_precision())
    else:
        ctx = {"TF32 requested": _Precision("high"), "bf16 requested": _Precision("medium"),
               "twice the cores in threads": _Threads(2 * (os.cpu_count() or 1))}[state]
    with ctx:
        got = cpu.loglik_batch(cb, bb)
        if isinstance(ctx, _Precision):  # and the engine left the caller's setting as it was
            assert torch.get_float32_matmul_precision() == ctx.p
    np.testing.assert_array_equal(got, clean)


def test_clean_value_matches_float64_and_jax(clean):
    """The clean float32 value within 1e-6 relative of phase 3c's float64
    arbiter and within 1e-5 of JAX's engine on the same inputs."""
    from unicore_tpu.phylo import likelihood as jl
    from unicore_tpu.phylo import models as jm

    msa, cpu, cb, bb = _inputs()
    f64 = np.array(_chip_smoke().float64_loglik(cpu, cb, bb))
    np.testing.assert_allclose(clean, f64, rtol=1e-6, atol=0)
    names = list(msa)
    seqs = [msa[k] for k in names]
    freqs = jl.empirical_frequencies(jl.msa_to_codes(names, seqs))
    model = jm.SubstModel.build(jm.ModelSpec.parse(MODEL), empirical_freqs=freqs, alpha=ALPHA, p_inv=P_INV)
    jax_ll = np.asarray(jl.LikelihoodEngine(names, seqs, model).loglik_batch(cb, bb))
    np.testing.assert_allclose(clean, jax_ll, rtol=1e-5, atol=0)


def test_openmp_team_state():
    """chip_smoke.OpenMPTeam reads every thread of torch's intra-op team:
    one entry a thread, round to nearest, FTZ and DAZ off; cpu_state
    puts them on one line."""
    c = _chip_smoke()
    team = c.OpenMPTeam()
    with _Threads(3):
        workers = team.workers()
        line = c.cpu_state(team)
    assert sorted(workers) == [0, 1, 2]
    assert len({w[0] for w in workers.values()}) == 3  # three threads
    assert all(w[2:] == ("nearest", False, False) for w in workers.values()), workers
    assert line.startswith("matmul precision ") and "OpenMP team" in line and line.count("nearest") == 3


_REPRO = r"""
import json, os, runpy, sys
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])  # torch takes two threads, the sweep two cores
sys.modules["jax"] = None  # any import of jax now fails
sys.argv = ["torch_phylo_repro.py", "--skip", "build,cpu-run", "--taxa", "8", "--columns", "300",
            "--repeats", "4", "--sweep-reps", "1"]
try:
    runpy.run_path("scripts/torch_phylo_repro.py", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(n for n, m in sys.modules.items() if m is not None
             and (n in ("jax", "unicore_tpu") or n.startswith(("jax.", "unicore_tpu."))))
print(json.dumps({"exit": code, "bad": bad}))
"""


def test_reproducer_runs_without_jax():
    """scripts/torch_phylo_repro.py with the card's phases and phase 5's
    CPU run skipped: no JAX, no repeat differs, every candidate within
    1e-6 of float64, and each core of the sweep clean."""
    env = dict(os.environ, PYTHONPATH=REPO, UNICORE_TPU_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", _REPRO], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    summary, end = json.loads(lines[-2]), json.loads(lines[-1])
    assert end == {"exit": 0, "bad": []}, res.stdout[-3000:]
    assert summary["repeats"] == 4 and summary["differing"] == 0 and summary["max_rel_err"] <= 1e-6
    assert summary["skipped"] == ["2", "2b", "2c", "3b", "build", "cpu-run"]


_PERTURB = r"""
import os, runpy, sys
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
sys.modules["jax"] = None  # any import of jax now fails
sys.argv = ["torch_phylo_perturb.py", "--taxa", "8", "--columns", "300"]
try:
    runpy.run_path("scripts/torch_phylo_perturb.py", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(n for n, m in sys.modules.items() if m is not None
             and (n in ("jax", "unicore_tpu") or n.startswith(("jax.", "unicore_tpu."))))
assert not bad, bad
"""


def test_perturbation_table_runs_without_jax():
    """scripts/torch_phylo_perturb.py on a small size without JAX: the
    clean line, then one line of two shifts per perturbation, the
    FTZ/DAZ and per-candidate ones leaving candidate 5 where it was."""
    env = dict(os.environ, PYTHONPATH=REPO, UNICORE_TPU_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", _PERTURB], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("clean: candidates 4, 5") and "float64" in lines[0]
    rows = dict(line.rsplit(": ", 1) for line in lines[1:])
    assert len(rows) == 4 + 4 + 7 + 6
    assert all(v.split(", ")[1] == "+0.0000" for k, v in rows.items() if k.startswith(("candidate 4", "a page")))
