"""prostt5_mfu: model FLOPs of the window over the card's bf16 peak.

The FLOPs are those of the framed units the inputs need
(`counts.model_flops` of the driver's `unit_residues`: one unit a
protein, one a window past 2,048 residues, each [prefix, residues,
eos]), never those of the batches the program formed, so padding and
batching show here.  They are divided by the window's seconds on the
host clock (the traced window) and the data sheet's 989 TFLOP/s dense
bf16 (`peaks.json`).  None on a device the table does not hold.
"""

from port_bench import counts


def read(run):
    if run.peaks is None or run.trace is None or not run.trace["device"]:
        return None
    flops = counts.model_flops(run.context["unit_residues"], run.cfg)
    value = 100.0 * flops / (run.window_s * run.peaks["bf16_flops_per_s"])
    run.note(f"prostt5_mfu {value:.4f} %: {flops:.6e} model FLOPs in {run.window_s:.3f} s "
             f"against {run.peaks['bf16_flops_per_s']:.4g} FLOP/s "
             f"(power limit {run.peaks['power_limit_w']} W in the table)")
    return value
