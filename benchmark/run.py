"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
comparison read beside its limit, also the last lines of standard error).
Without the CUDA cards the cell asks for it prints no result and exits 2.
See ``benchmark/README.md``.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench_cache"

if __name__ == "__main__":
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness import runner
    sys.exit(runner.main(sys.argv[1:], T_START))
