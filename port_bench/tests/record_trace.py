"""Record a small compact trace on the card, for the readers' CPU tests.

    python3 port_bench/tests/record_trace.py OUT.json [--workload createdb.eukaryote]

One call of a few proteins (one past the window, so that the windowed
path runs) through the cell's engine under the harness's profiler, the
compact trace (`devtrace.record`) written to OUT.json with the kernel
names cut to 60 characters.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--workload", default="createdb.eukaryote")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from port_bench import devtrace, harness

    spec = harness.load_spec()
    _, cfg, traffic = harness.cell_files(spec, args.workload)
    mod = harness.load_module(os.path.join(harness.HERE, "drivers", cfg["driver"] + ".py"), "driver")
    drv = mod.Driver(cfg, traffic, args.seed, "cuda")
    drv.build()
    proteins = ["MKV" * 40, "ACDEFGHIKLMNPQRSTVWY" * 9, "MSTNPKPQRKTKRNTNRRPQDVKFPGG" * 86]
    drv.run(proteins)
    torch.cuda.synchronize()
    with devtrace.profiler() as prof:
        with devtrace.call_span():
            drv.run(proteins)
        torch.cuda.synchronize()
    tr = devtrace.record(prof)
    tr["device"] = [[name[:60], s, t, op] for name, s, t, op in tr["device"]]
    tr["proteins"] = [len(p) for p in proteins]
    with open(args.out, "w") as f:
        json.dump(tr, f, separators=(",", ":"))
    print(f"{len(tr['device'])} device events, {len(tr['ops'])} ops, {len(tr['frames'])} frames; "
          f"busy {devtrace.busy_s(tr):.6f} s of {devtrace.window_s(tr):.6f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
