"""Run one cell of the benchmark of visma_tpu_torch.

    python3 -m portbench.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. Prints the result as one JSON object, the
last line of standard output; see portbench/harness.py."""
import time

T_START = time.time()   # set-up is timed from here

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
