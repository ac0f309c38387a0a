"""Run one cell of BENCHMARK.json once, on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, device init, weights made
on the device, the driver's warm-up) counts as `setup_s`; then whole calls
run until `--seconds` have passed.  With `--trace 0` the result holds
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics,
read from a profiler trace of the window, and the trace's breakdown.
The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit.  With no CUDA card, or fewer than the cell asks for, it exits 2
and prints no result; if a module of JAX or of the JAX package was
loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
BUILD = os.path.join(ROOT, "build", "port_bench")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(BUILD, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"needs {cell['chips']} CUDA card(s); torch sees {n}")
        return 2
    torch.cuda.init()
    torch.empty(1, device="cuda")
    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_START)
    except harness.Forbidden as err:
        harness.log(str(err))
        return 3
    for name, c in result["compared"].items():
        harness.log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
