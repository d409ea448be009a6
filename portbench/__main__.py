"""python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

sys.exit(main(t_start=T_START))
