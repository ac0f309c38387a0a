"""Spans and counters inside the ProstT5 engine (runtime/profiling.py,
models/prostt5.py) and the benchmark's readers of them
(port_bench/metrics/{attention_span_roofline,batch_gap_pct,engine_host_pct}.py).

On the CPU at T5Config.small(): a span is the shared no-op while no
profiler records; under torch.profiler every phase of the engine shows
in the profiler's trace as often as it runs; the letters are the same
with spans on and off; the shape counters add up to the padded tokens;
the bias table's builds are its cache's misses; each reader gives the
hand-computed value of a made-up run.  The one `cuda` test reads the
device-clock spans on the card.  Imports nothing of JAX, so the `cuda`
test also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import harness
from torch_port_helpers import need_cuda
from unicore_tpu_torch.models import prostt5 as P
from unicore_tpu_torch.runtime import profiling

LETTERS = "ACDEFGHIKLMNPQRSTVWY"
BATCH_PHASES = ("fill", "frame", "copy_in", "forward", "copy_out", "decode", "bias_table")
PEAKS = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
XL = {"num_heads": 32, "d_kv": 128, "num_layers": 24}


def _seqs(seed, lengths):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(list(LETTERS), n)) for n in lengths]


# windows of 200 overlapping by 100: 240 and 300 residues are read in two
# windows each, so 16 units; at 1,024 tokens a batch they form batches
# of 8 and 2 units in the bucket of 128 and one of 6 in that of 256
LENGTHS = [5, 30, 60, 90, 120, 126, 40, 70, 100, 20, 150, 240, 300, 130]


@pytest.fixture(scope="module")
def engine():
    eng = P.ProstT5Engine(cfg=P.T5Config.small(), batch_tokens=8 * 128, device="cpu")
    eng.max_window, eng.overlap = 200, 100
    return eng


def _delta(before, prefix=""):
    after = profiling.get_counters()
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if k.startswith(prefix) and v != before.get(k, 0.0)}


def test_span_is_the_shared_no_op_without_a_profiler():
    before = profiling.get_counters()
    a, b = profiling.span("test.a"), profiling.span("test.b", device=True)
    assert a is b
    with a:
        pass
    gap = profiling.DeviceGap("test.gap")
    gap.after(True)
    gap.before()
    profiling.read_device_spans()
    assert profiling.get_counters() == before


def test_engine_spans_under_the_profiler(engine):
    seqs = _seqs(1, LENGTHS)
    before = profiling.get_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.predict(seqs)
        engine.predict(seqs[:3])
        counted = _delta(before)
    batches = counted["prostt5.batches"]
    assert batches == 3 + 1
    expect = {f"prostt5.{p}": batches for p in BATCH_PHASES}
    expect["prostt5.attention"] = engine.cfg.n_layers * batches
    expect["prostt5.stitch"] = 2 * 2  # cutting the windows, then stitching them, a predict
    for name, n in expect.items():
        assert counted[name + ".calls"] == n, name
        assert counted[name + ".seconds"] > 0, name
    assert not any(k.endswith(".device_seconds") for k in counted)  # the CPU has no device clock


def test_engine_spans_in_key_averages(engine):
    seqs = _seqs(2, LENGTHS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.predict(seqs)
    calls = {e.key: e.count for e in prof.key_averages() if e.key.startswith("prostt5.")}
    assert calls == {**{f"prostt5.{p}": 3 for p in BATCH_PHASES},
                     "prostt5.attention": 3 * engine.cfg.n_layers, "prostt5.stitch": 2}


def test_letters_equal_with_spans_on_and_off(engine):
    seqs = _seqs(3, LENGTHS)
    off = engine.predict(seqs)
    with profile(activities=[ProfilerActivity.CPU]):
        on = engine.predict(seqs)
    assert on == off and [len(s) for s in on] == LENGTHS


def test_shape_counters_add_up_to_padded_tokens(engine):
    before = profiling.get_counters()
    engine.predict(_seqs(4, LENGTHS))
    counted = _delta(before, "prostt5.")
    shapes = {k: v for k, v in counted.items() if k.startswith("prostt5.shape.")}
    assert shapes == {"prostt5.shape.8x128.batches": 2, "prostt5.shape.8x256.batches": 1}
    tokens = sum(n * int(k.split(".")[2].split("x")[0]) * int(k.split(".")[2].split("x")[1])
                 for k, n in shapes.items())
    assert tokens == counted["prostt5.padded_tokens"]
    assert sum(shapes.values()) == counted["prostt5.batches"]


def test_bias_table_builds_count_the_cache_misses():
    P._offset_buckets.cache_clear()
    lengths = [128 * k for k in range(1, 18)]  # 17 buckets, 128 to 2,176
    before = profiling.get_counters().get("prostt5.bias_table.builds", 0.0)
    misses = P._offset_buckets.cache_info().misses
    for _ in range(2):
        for L in lengths:
            P._bucket_table(L, 32, 128)
    builds = profiling.get_counters()["prostt5.bias_table.builds"] - before
    assert builds == P._offset_buckets.cache_info().misses - misses
    assert builds >= len(lengths)
    if P._offset_buckets.cache_info().maxsize < len(lengths):
        assert builds == 2 * len(lengths)  # cycled in order, each length misses again


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"), "metric_" + name)


def _run(counters, window_s=10.0):
    return harness.Run(XL, counters, window_s, None, PEAKS, {})


def _attention_least_s(B, L):
    H, d = XL["num_heads"], XL["d_kv"]
    flops = 4 * B * H * L * L * d
    nbytes = 4 * B * H * L * d * 2 + H * L * L * 4 + B * L
    return max(flops / 989e12, nbytes / 3.35e12)


def test_attention_span_roofline_by_hand():
    counters = {"prostt5.shape.64x512.batches": 3.0, "prostt5.shape.16x2176.batches": 2.0,
                "prostt5.shape.8x128.batches": 0.0, "prostt5.attention.device_seconds": 0.5,
                "prostt5.batches": 5.0}
    least = 24 * (3 * _attention_least_s(64, 512) + 2 * _attention_least_s(16, 2176))
    assert _reader("attention_span_roofline").read(_run(counters)) == pytest.approx(100 * least / 0.5)


def test_batch_gap_pct_by_hand():
    counters = {"prostt5.between_batches.device_seconds": 0.25}
    assert _reader("batch_gap_pct").read(_run(counters, 12.5)) == pytest.approx(2.0)
    assert _reader("batch_gap_pct").read(_run({"prostt5.between_batches.device_seconds": 0.0})) == 0.0


def test_engine_host_pct_by_hand():
    counters = {"prostt5.fill.seconds": 0.01, "prostt5.frame.seconds": 0.2, "prostt5.copy_in.seconds": 0.03,
                "prostt5.decode.seconds": 0.05, "prostt5.stitch.seconds": 0.005,
                "prostt5.bias_table.seconds": 0.005, "prostt5.copy_out.seconds": 4.0,
                "prostt5.forward.seconds": 5.0, "prostt5.forward.device_seconds": 9.0}
    assert _reader("engine_host_pct").read(_run(counters, 10.0)) == pytest.approx(3.0)
    del counters["prostt5.forward.device_seconds"]  # spans on the CPU: no card
    assert _reader("engine_host_pct").read(_run(counters, 10.0)) is None


@pytest.mark.parametrize("name", ["attention_span_roofline", "batch_gap_pct", "engine_host_pct"])
def test_span_readers_without_counters_read_none(name):
    counters = {"prostt5.batches": 36.0, "prostt5.padded_tokens": 973824.0, "prostt5.shape.64x512.batches": 36.0}
    assert _reader(name).read(_run(counters)) is None
    assert _reader(name).read(_run({})) is None


def test_stage_names_itself_in_its_trace_and_a_nested_stage_in_the_outer(tmp_path, monkeypatch):
    monkeypatch.setenv("UNICORE_TPU_TORCH_TRACE_DIR", str(tmp_path))
    before = profiling.get_counters()
    with profiling.stage("unit-outer"):
        with profiling.stage("unit-inner"):
            torch.ones(8).sum()
    names = {e.get("name") for e in json.loads((tmp_path / "unit-outer.json").read_text())["traceEvents"]}
    assert {"stage.unit-outer", "stage.unit-inner"} <= names
    assert not (tmp_path / "unit-inner.json").exists()
    counted = _delta(before, "stage.unit-")
    assert counted["stage.unit-outer.calls"] == counted["stage.unit-inner.calls"] == 1
    assert counted["stage.unit-outer.seconds"] >= counted["stage.unit-inner.seconds"] > 0


@pytest.mark.cuda
def test_device_spans_on_the_card():
    need_cuda()
    eng = P.ProstT5Engine(cfg=P.T5Config.small(), batch_tokens=8 * 128, device="cuda")
    eng.max_window, eng.overlap = 200, 100
    seqs = _seqs(5, LENGTHS)
    off = eng.predict(seqs)
    before = profiling.get_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = eng.predict(seqs)
    counted = _delta(before)
    assert on == off
    forward, attention = counted["prostt5.forward.device_seconds"], counted["prostt5.attention.device_seconds"]
    assert forward > 0 and attention > 0 and forward >= attention
    assert counted["prostt5.between_batches.device_seconds"] > 0
