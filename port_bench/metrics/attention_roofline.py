"""attention_roofline: attention's share of its roofline.

The rule: a device event belongs to attention when the op that launched
it ran inside one call of the program's `_attention` (the score product
`_scores` with its bias add, the softmax, the cast, probs·v and the
copy out).  Each call is one layer of one batch as launched; its FLOPs
are 4·rows·heads·L²·d_kv and its bytes q, k, v and the output read or
written once, the float32 relative bias (heads, L, L) and the key mask
read once (`counts.attention_cost`), with rows and L read from the
products' recorded shapes.  Its least time is the larger of FLOPs over
the bf16 peak and bytes over the HBM bandwidth; the share is the sum of
the least times over the device time of every kernel the calls
launched.  None where the trace holds none.
"""

from port_bench import counts, devtrace

PRODUCTS = ("aten::bmm", "aten::mm", "aten::matmul", "aten::baddbmm")


def attention_call(tr, op):
    """Index of the `_attention` frame op `op` ran in, else None."""
    if op < 0:
        return None
    for i in reversed(tr["ops"][op][3]):
        if devtrace.func(tr["frames"][i][0]) == "_attention":
            return i
    return None


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None:
        return None
    time_us = devtrace.device_time_by(tr, lambda op: attention_call(tr, op))
    if not time_us:
        return None
    H, d = run.cfg["num_heads"], run.cfg["d_kv"]
    shapes = {}
    for op, (name, sh, _, chain) in enumerate(tr["ops"]):
        call = attention_call(tr, op)
        if call is not None and name in PRODUCTS:
            bt, m, _, _ = counts.matmul_dims(sh[0], sh[1])
            acc = shapes.setdefault(call, [0, m])
            acc[0] += bt
    bound = {"compute": 0.0, "memory": 0.0}
    for call in time_us:
        if call not in shapes:
            continue
        heads_rows, L = shapes[call]
        flops, nbytes = counts.attention_cost(heads_rows // (2 * H), H, L, d)
        sec, which = counts.bound_s(flops, nbytes, run.peaks)
        bound[which] += sec
    total = sum(time_us.values()) / 1e6
    value = 100.0 * sum(bound.values()) / total
    run.note(f"attention_roofline {value:.4f} %: {len(time_us)} calls, device {total:.6f} s, "
             f"least {bound['compute']:.6f} s bound by compute and {bound['memory']:.6f} s by memory")
    return value
