"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It makes its inputs from the seed, sets
up and warms up, measures for ``--seconds``, checks what the timed path
produced against ``perfbench/reference/``, and prints one JSON line as
the last line of its standard output (see ``harness.py``).  It needs as
many CUDA devices as the cell asks for, and exits non-zero without a
result when they are missing, or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout, so only the
# first run of a checkout builds; nothing of JAX is loaded by a library
_CACHE = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
# the script's own folder is not a place to import from (its module
# names would shadow the standard library's): the checkout's root is
sys.path[0] = str(ROOT)

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
