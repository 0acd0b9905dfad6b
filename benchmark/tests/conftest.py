"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root.  Tests marked ``cuda`` need a card and skip without
one (decided inside the test)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)
