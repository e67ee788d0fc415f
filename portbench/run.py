#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints the run's result as the last line of standard output (see
portbench/harness/main.py). It needs an NVIDIA card and the CUDA toolkit;
without a card it exits 2 and prints no result.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
