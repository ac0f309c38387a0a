"""batch_gap_pct: the share of the window the device spent between the
engine's batches.

100 × `prostt5.between_batches.device_seconds` / the window's seconds:
the device clock's time from the end of one batch's `prostt5.forward`
span to the start of the next one's within a call (the copy out, the
next batch's copy in, and whatever the device waits for the host
there).  What `device_idle_pct` shows beyond it is idle time inside the
model step or between calls.  None where the program counted no such
time.
"""


def read(run):
    gap_s = run.counters.get("prostt5.between_batches.device_seconds")
    if gap_s is None:
        return None
    return 100.0 * gap_s / run.window_s
