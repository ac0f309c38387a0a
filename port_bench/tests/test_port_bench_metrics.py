"""Each per-layer metric reader, the union of device intervals and the
breakdown on a small hand-made trace, the same on a trace recorded on
the card, and the frames an op ran in on a real CPU profile."""

import os

import pytest

from port_bench import counts, devtrace, harness

PEAKS = counts.peaks("NVIDIA H100 80GB HBM3")
XL = {"d_model": 1024, "d_ff": 16384, "num_heads": 32, "d_kv": 128, "num_layers": 24,
      "feed_forward_proj": "relu", "cnn_hidden": 32, "cnn_kernel": 7, "n_classes": 20}
BF = ["c10::BFloat16", "c10::BFloat16"]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def hand_trace():
    """One forward's worth of a layer: a q projection (two kernels that
    overlap), attention of 16 rows at L 128 (scores, softmax, probs·v),
    the FFN's wi product, a copy in, and host framing at the end."""
    return {
        "window": [0.0, 1000.0],
        "calls": [[0.0, 1000.0]],
        "frames": [["prostt5.py:_predict_units", 0.0, 1000.0], ["prostt5.py:self_attention", 10.0, 400.0],
                   ["prostt5.py:_attention", 100.0, 300.0], ["prostt5.py:feed_forward", 400.0, 800.0],
                   ["prostt5.py:frame_batch", 850.0, 990.0]],
        "ops": [["aten::mm", [[4096, 1024], [1024, 4096]], BF, [0, 1]],
                ["aten::bmm", [[512, 128, 128], [512, 128, 128]], BF, [0, 1, 2]],
                ["aten::_softmax", [[16, 32, 128, 128]], ["float"], [0, 1, 2]],
                ["aten::bmm", [[512, 128, 128], [512, 128, 128]], BF, [0, 1, 2]],
                ["aten::mm", [[4096, 1024], [1024, 16384]], BF, [0, 3]],
                ["aten::copy_", [[16, 128], [16, 128]], ["long", "long"], [0]]],
        "device": [["copy", 5.0, 15.0, 5], ["gemm_q", 20.0, 60.0, 0], ["gemm_q_reduce", 55.0, 70.0, 0],
                   ["bmm_scores", 110.0, 150.0, 1], ["softmax", 150.0, 200.0, 2], ["bmm_pv", 200.0, 220.0, 3],
                   ["gemm_wi", 420.0, 700.0, 4]],
    }


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"), "metric_" + name)


def run_of(tr, counters=None, window_s=1e-3, units=()):
    return harness.Run(XL, counters or {}, window_s, tr, PEAKS, {"unit_residues": list(units)})


def test_overhead_records_are_no_device_work():
    frames = [(0, 1000, "prostt5.py:self_attention")]
    ops = {7: (100, "aten::mm", [[8, 8], [8, 8]], BF)}
    dev = [(200, 300, "nvjet_gemm", 7), (150, 900, "Command Buffer Full", 7), (0, 1000, "Buffer Flush", 7)]
    tr = devtrace.compact(frames, ops, dev, [(0, 1000)])
    assert [d[0] for d in tr["device"]] == ["nvjet_gemm"]
    assert devtrace.busy_s(tr) == pytest.approx(100e-9)


def test_union_counts_overlap_once():
    tr = hand_trace()
    assert devtrace.busy_intervals(tr) == [(5.0, 15.0), (20.0, 70.0), (110.0, 220.0), (420.0, 700.0)]
    assert devtrace.busy_s(tr) == pytest.approx(450e-6)
    assert reader("device_idle_pct").read(run_of(tr)) == pytest.approx(55.0)


def test_gemm_roofline_by_hand():
    q = max(2 * 4096 * 1024 * 4096 / 989e12, 2 * (2 * 4096 * 1024 + 4096 * 4096) / 3.35e12)
    wi = max(2 * 4096 * 1024 * 16384 / 989e12, 2 * (4096 * 1024 + 1024 * 16384 + 4096 * 16384) / 3.35e12)
    got = reader("gemm_roofline").read(run_of(hand_trace()))
    assert got == pytest.approx(100 * (q + wi) / ((40 + 15 + 280) * 1e-6))


def test_attention_roofline_by_hand():
    flops = 4 * 16 * 32 * 128 * 128 * 128
    nbytes = 4 * 16 * 32 * 128 * 128 * 2 + 32 * 128 * 128 * 4 + 16 * 128
    least = max(flops / 989e12, nbytes / 3.35e12)
    got = reader("attention_roofline").read(run_of(hand_trace()))
    assert got == pytest.approx(100 * least / 110e-6)


def test_counter_readers_and_mfu():
    counters = {"prostt5.residues": 750.0, "prostt5.padded_tokens": 1000.0, "prostt5.peak_bytes": 3 * 2**30}
    run = run_of(hand_trace(), counters, window_s=2.0, units=[300, 2048])
    assert reader("padding_pct").read(run) == pytest.approx(25.0)
    assert reader("peak_device_gib").read(run) == pytest.approx(3.0)
    flops = 24 * (counts.layer_flops(302, XL) + counts.layer_flops(2050, XL)) \
        + counts.head_flops(300, XL) + counts.head_flops(2048, XL)
    assert reader("prostt5_mfu").read(run) == pytest.approx(100 * flops / (2.0 * 989e12))
    assert reader("padding_pct").read(run_of(hand_trace())) is None
    assert reader("peak_device_gib").read(run_of(hand_trace())) is None


def test_readers_find_nothing_return_none():
    empty = dict(hand_trace(), device=[], ops=[])
    for name in ("gemm_roofline", "attention_roofline", "device_idle_pct", "prostt5_mfu"):
        assert reader(name).read(run_of(empty)) is None
        assert reader(name).read(harness.Run(XL, {}, 1.0, None, PEAKS, {"unit_residues": [10]})) is None


def test_breakdown_by_hand():
    b = devtrace.breakdown(hand_trace())
    ops = dict(b["device_ops"])
    assert ops["aten::mm@feed_forward"] == pytest.approx(280e-6)
    assert ops["aten::mm@self_attention"] == pytest.approx(55e-6)
    assert ops["aten::bmm@_attention"] == pytest.approx(60e-6)
    gaps = {name: sec for name, sec in b["idle_gaps"]}
    assert gaps == pytest.approx({"prostt5.py:frame_batch (1 gaps)": 300e-6,
                                  "prostt5.py:self_attention (3 gaps)": 245e-6,
                                  "prostt5.py:_predict_units (1 gaps)": 5e-6})
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_recorded_card_trace():
    """A trace recorded on the card (tests/record_trace.py): one call of
    three proteins, one past the window, at full width."""
    path = os.path.join(DATA, "trace_small.json")
    tr = harness.load_json(path)
    run = run_of(tr, window_s=devtrace.window_s(tr), units=counts.unit_residues(tr["proteins"], 2048, 256))
    assert 0 < devtrace.busy_s(tr) <= devtrace.window_s(tr)
    for name in ("gemm_roofline", "attention_roofline", "prostt5_mfu"):
        assert 0 < reader(name).read(run) <= 100, name
    assert 0 <= reader("device_idle_pct").read(run) < 100
    b = devtrace.breakdown(tr)
    assert b["device_ops"] and b["idle_gaps"]
    assert any("@feed_forward" in k for k, _ in b["device_ops"])


def test_frames_of_ops_on_a_cpu_profile():
    """`compact` ties each product of a real (CPU) profile of the engine to
    the program's frames: projections and FFN products outside
    `_attention`, the score and value products inside it."""
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.models import prostt5 as P

    eng = P.ProstT5Engine(cfg=P.T5Config(d_model=64, d_kv=16, n_heads=4, d_ff=128, n_layers=2), device="cpu")
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_stack=True) as prof:
        with devtrace.call_span():
            eng.predict(["MKVLAT" * 10, "ACDEF" * 7])
    ops, dev, calls = {}, [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if e.name() == devtrace.CALL_SPAN:
            calls.append((s, t))
        elif not devtrace._is_python(e):
            ops[e.correlation_id()] = (s, e.name(), [list(x) for x in e.shapes()], list(e.dtypes()))
            if e.name() in ("aten::mm", "aten::bmm"):  # stand-ins for the kernels they would launch
                dev.append((s, t, e.name(), e.correlation_id()))
    tr = devtrace.compact(devtrace._frames(prof.profiler.kineto_results), ops, dev, calls)
    kinds = {}
    for name, _, _, op in tr["device"]:
        fs = devtrace.op_funcs(tr, op)
        assert "_predict_units" in fs
        kinds.setdefault(name, set()).add("_attention" in fs)
        if name == "aten::mm":
            assert "self_attention" in fs or "feed_forward" in fs
    assert kinds == {"aten::mm": {False}, "aten::bmm": {True}}
    gemm = reader("gemm_roofline").is_gemm
    assert sum(gemm(tr, op) for *_, op in tr["device"]) == 2 * 6  # q, k, v, o, wi, wo a layer
