"""device_idle_pct: the share of the traced window in which no operation
ran on the device.

100 × (1 − the union of the device events' intervals over the window),
the window being the harness's call spans from the first call's start
to the last call's end on the trace's clock.  Overlapping events count
once.  None where the trace holds no device event.
"""

from port_bench import devtrace


def read(run):
    if run.trace is None or not run.trace["device"]:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(run.trace) / devtrace.window_s(run.trace))
