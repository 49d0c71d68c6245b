"""Read the numbers that decide ``correct`` over many seeds in one
process: the program's sound runs (the lower readings) and, with
``--control``, the control's (the upper readings), each run at the cell's
own sizes and load for a short window.

    python3 portbench/limits.py --workload <cell> --seeds 1,2,3 [--control]
        [--seconds 3]

One JSON line a seed on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = {}
        result = harness.run(args.workload, seed, args.seconds, False, control=args.control,
                             numbers=numbers)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
