"""gemm_roofline: the linear products' share of their roofline.

The rule: a device event belongs to the linear products when the op that
launched it (tied through the profiler's correlation ids) is a matrix
product (`aten::mm`, `addmm`, `bmm`, `linear`, `matmul`) and ran inside
the program's `self_attention` or `feed_forward` but not inside
`_attention`: the q, k, v and o projections and the FFN's wi and wo.
Each such op's FLOPs (2·m·k·n, the batch as launched, padded B × L) and
bytes (A and B read once, C written once, at the dtypes recorded)
give its least time, the larger of FLOPs over the bf16 peak and bytes
over the HBM bandwidth; the share is the sum of those least times over
the device time of the kernels those ops launched.  None where the trace
holds none.
"""

from port_bench import counts, devtrace

PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::linear", "aten::matmul")


def operands(name, shapes):
    """(A, B) shapes of a product op as the profiler records its inputs."""
    if name == "aten::addmm":
        return shapes[1], shapes[2]
    if name == "aten::linear":
        return shapes[0], list(reversed(shapes[1]))
    return shapes[0], shapes[1]


def is_gemm(tr, op):
    if op < 0 or tr["ops"][op][0] not in PRODUCTS:
        return False
    fs = devtrace.op_funcs(tr, op)
    return "_attention" not in fs and ("self_attention" in fs or "feed_forward" in fs)


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None:
        return None
    time_us = devtrace.device_time_by(tr, lambda op: op if is_gemm(tr, op) else None)
    if not time_us:
        return None
    bound = {"compute": 0.0, "memory": 0.0}
    for op in time_us:
        name, shapes, dtypes, _ = tr["ops"][op]
        a, b = operands(name, shapes)
        nb = counts.DTYPE_BYTES.get(str(dtypes[0]).split("::")[-1].lower(), 2) if dtypes else 2
        flops, nbytes = counts.gemm_cost(a, b, nb, nb)
        sec, which = counts.bound_s(flops, nbytes, run.peaks)
        bound[which] += sec
    total = sum(time_us.values()) / 1e6
    value = 100.0 * sum(bound.values()) / total
    run.note(f"gemm_roofline {value:.4f} %: {len(time_us)} products, device {total:.6f} s, "
             f"least {bound['compute']:.6f} s bound by compute and {bound['memory']:.6f} s by memory")
    return value
