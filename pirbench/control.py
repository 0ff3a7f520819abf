#!/usr/bin/env python3
"""The check's control: the plain reference, computed in float32 with
TF32 off, put in the program's place for the hint and the answers that
the check compares, at the cell's own size, on several seeds.

    python3 pirbench/control.py --workload ctr-2p20-a3.lookup --seeds 11 12 13 --seconds 3

Each seed is one run of the cell (set-up, a short window at the cell's
own load, then the check with the control's outputs), in this process.
One JSON line a seed gives every number the check compared; the last
line gives each number's smallest reading over the seeds, the upper
reading its limit is set below. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pirbench import harness

    import torch

    if not torch.cuda.is_available():
        print("pirbench control: no CUDA device", file=sys.stderr)
        return 2
    least: dict = {}
    for seed in args.seeds:
        result = harness.run(args.workload, seed, args.seconds, False, control=True,
                             t_start=time.perf_counter())
        readings = {name: c["value"] for name, c in result["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "readings": readings}), flush=True)
        for name, value in readings.items():
            least[name] = min(value, least.get(name, value))
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
