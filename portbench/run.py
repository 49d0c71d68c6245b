"""Run one benchmark cell once and print its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs the cell's CUDA cards and exits with 1, printing no result,
without them.
"""

import os
import sys
import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main(started=STARTED))
