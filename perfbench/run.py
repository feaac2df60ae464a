"""The benchmark of multiprime_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (correct, attempted, failed, metrics, device, breakdown when
traced, checks); the checks' numbers and limits are also the last lines of
standard error.  No card, or too few, and no result: exit 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
if __name__ == "__mp_main__":
    # a worker of the program's spawned pool: record what its device
    # stages produce, for the check (capture.py)
    from perfbench import capture
    capture.install()

if __name__ == "__main__":
    from perfbench import harness
    sys.exit(harness.main(t_start=T_START))
