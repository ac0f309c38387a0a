"""The readings a cell's limits are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]

For each seed, in one process: the weights made on the device from the
seed, the engine, the window's first call of that seed (its longest
protein and more than a run's sample), the gaps of the run's sample
against the float32 reference (`Driver.check`'s numbers) and the seed's
gauge (`Driver.gauge`); for each control seed also the gaps of the
letters that the reference computed in fp8 puts first, of those it puts
first with every norm weight taken as 1, and of a token altered where it
is produced (`Driver.readings`).  One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from port_bench import generator, harness

    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell_files(spec, args.workload)
    mod = harness.load_module(os.path.join(harness.HERE, "drivers", cfg["driver"] + ".py"), "driver")
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        drv = mod.Driver(cfg, traffic, seed, "cuda")
        drv.build()
        proteins = generator.draw_call(drv.mix, seed, 0)
        served = drv.run(proteins)
        drv.release()
        out = drv.readings(proteins, served, seed in args.control_seeds)
        out.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        drv.state = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
