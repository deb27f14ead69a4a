#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``<cell>`` is a ``workloads`` name of
``BENCHMARK.json``.  The last line of standard output is the result, one
JSON object; the numbers the check compared, each beside its limit, are
the last lines of standard error.  Without a CUDA card (or with fewer than
the cell asks for) it prints no result and exits 2.  The kernels'
libraries and every other cache stay under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    os.environ["USE_FLAX"] = "0"
    # the checkout's package and the harness, not this script's folder
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness.main import main as run
    return run(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
