"""peak_device_gib: the device memory the engine's process held at most.

`prostt5.peak_bytes`, the engine's counter of torch.cuda's
max_memory_allocated since the process started, in GiB.  None where the
engine ran on no card.
"""


def read(run):
    peak = run.counters.get("prostt5.peak_bytes")
    return None if not peak else peak / 2**30
