"""engine_host_pct: the share of the window the engine's serial host
work took.

100 × the host seconds of the engine's spans `prostt5.fill`, `frame`,
`copy_in`, `decode`, `stitch` and `bias_table` / the window's seconds.
A change that overlaps host work with the device lowers `batch_gap_pct`
and leaves this share where it is.  None where the engine's spans ran
on no card (no `prostt5.forward.device_seconds`): on the CPU the host
does the model's work as well.
"""

PHASES = ("fill", "frame", "copy_in", "decode", "stitch", "bias_table")


def read(run):
    c = run.counters
    if c.get("prostt5.forward.device_seconds", 0.0) <= 0:
        return None
    host_s = sum(c.get(f"prostt5.{p}.seconds", 0.0) for p in PHASES)
    run.note("engine_host_pct: " + ", ".join(f"{p} {c.get(f'prostt5.{p}.seconds', 0.0):.6f} s" for p in PHASES)
             + f" in {run.window_s:.3f} s")
    return 100.0 * host_s / run.window_s
