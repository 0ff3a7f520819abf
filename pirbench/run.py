#!/usr/bin/env python3
"""The benchmark of chalametpir_tpu_torch on NVIDIA GPUs: one cell a run.

    python3 pirbench/run.py --workload ctr-2p20-a3.lookup --seed 1 --seconds 51 --trace 0

Runs the cell of BENCHMARK.json named by --workload (harness.py): set-up
from --seed, a measured window of --seconds, then the check against the
plain reference. The last line of standard output is the result, one
JSON object: with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics from a torch.profiler trace of the same window.
The last lines of standard error give each number compared beside its
limit. Without as many CUDA devices as the cell asks for, or with jax,
jaxlib, flax or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pirbench import harness

    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"pirbench: the cell needs {cell.entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"pirbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result, separators=(",", ":")), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']}, of {check['compared']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
