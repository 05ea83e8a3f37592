"""The benchmark of bodywork_tpu_torch on the card, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root. Exits non-zero, printing no result, where
the card or the port is missing, or where JAX or the JAX package was
loaded. See ``portbench/__init__.py`` for where each piece lives.
"""
import time

START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
