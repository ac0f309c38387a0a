"""attention_span_roofline: attention's share of its roofline, on the
program's own spans.

The work is counted where the engine forms its batches: each batch of
`prostt5.shape.<B>x<L>.batches` (B padded rows at bucket length L) runs
`num_layers` attention calls, each of the least time
`counts.bound_s(counts.attention_cost(B, num_heads, L, d_kv))`.  The
time is `prostt5.attention.device_seconds`, the device clock's time
inside the engine's `prostt5.attention` spans, whatever kernels run
there.  None where the program counted no such time.
"""

import re

from port_bench import counts

SHAPE = re.compile(r"prostt5\.shape\.(\d+)x(\d+)\.batches")


def read(run):
    device_s = run.counters.get("prostt5.attention.device_seconds", 0.0)
    if device_s <= 0 or run.peaks is None:
        return None
    H, d, layers = run.cfg["num_heads"], run.cfg["d_kv"], run.cfg["num_layers"]
    least, batches = 0.0, 0
    for key, n in run.counters.items():
        m = SHAPE.fullmatch(key)
        if m and n > 0:
            flops, nbytes = counts.attention_cost(int(m.group(1)), H, int(m.group(2)), d)
            least += n * layers * counts.bound_s(flops, nbytes, run.peaks)[0]
            batches += n
    value = 100.0 * least / device_s
    run.note(f"attention_span_roofline {value:.4f} %: {batches:g} batches, spans {device_s:.6f} s on "
             f"the device, least {least:.6f} s")
    return value
