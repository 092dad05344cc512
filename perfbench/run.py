"""Run one cell of the benchmark (perfbench/harness.py says how):

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1
"""

import time

T0 = time.monotonic()  # set-up is timed from here, before torch is imported

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
