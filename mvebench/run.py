"""Run one cell of the mve_tpu_torch benchmark on this machine's card(s).

    python3 mvebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see README.md).
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from mvebench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
