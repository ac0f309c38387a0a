"""Whole runs of each cell at the tiny configuration on the CPU, the
result line's keys, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from port_bench.harness import ROOT

CELLS = ("createdb.bacteria", "createdb.eukaryote")

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run_tiny(spec, cfg, cell, seed, trace, seconds=0.5):
    from port_bench import harness

    return harness.run_cell(spec, cell, seed, seconds, trace, "cpu", time.perf_counter(), cfg=cfg)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(spec, tiny_cfg, cell, trace):
    from port_bench import harness

    r = run_tiny(spec, tiny_cfg, cell, 2**31 + 7, bool(trace))
    assert RESULT_KEYS <= set(r)
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= tiny_cfg["deployment"]["proteins_per_call"]
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.metrics_of(spec, cell, kind)}
    assert set(r["metrics"]) <= names
    if trace:
        # on the CPU only the program's counters read: no device, no peaks
        assert set(r["metrics"]) == {"padding_pct"}
        assert 0 < r["metrics"]["padding_pct"]["value"] < 100
    else:
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert set(r["compared"]) == {"failed_proteins", "flip_gap_ratio"}
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_warm_up_rule_matches_the_engine(spec, tiny_cfg, cell):
    """The batches the driver's warm-up works out are those the engine
    forms for a window's call, and the warm-up forms each shape once."""
    from port_bench import harness

    _, _, traffic = harness.cell_files(spec, cell)
    mod = harness.load_module(f"{harness.HERE}/drivers/createdb.py", "createdb_driver")
    drv = mod.Driver(tiny_cfg, traffic, 2**31 + 3, "cpu")
    before = drv.formed()
    split = dict(drv.setup(0.1))
    shapes = [drv.shape(b) for b in drv.batches(drv.call(0))]
    assert f"warm-up, {len(set(shapes))} shapes of {len(shapes)} batches" in split
    assert drv.start[0] - before[0] == len(set(shapes))
    drv.run(drv.call(0))
    end = drv.formed()
    assert (end[0] - drv.start[0], end[1] - drv.start[1]) == (len(shapes), sum(r * L for r, L in shapes))


def test_same_seed_same_inputs(tiny_cfg):
    from port_bench import generator

    m = generator.mix(tiny_cfg, {"composition": {"A": 1.0, "C": 2.0}})
    a, b = generator.draw_call(m, 12, 3), generator.draw_call(m, 12, 3)
    c = generator.draw_call(m, 13, 3)
    assert a == b and a != c
    assert sorted(map(len, a)) == sorted(map(len, c))


def test_no_card_no_result():
    """Without a CUDA card the command exits 2 and prints no result."""
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_run(need_cuda, cell):
    """One short run of the cell on the card: exit 0, the last line the
    result, correct."""
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed", "2147483659",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert RESULT_KEYS <= set(r) and r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.cuda
def test_card_run_without_the_program(need_cuda, tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness, a run
    fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
