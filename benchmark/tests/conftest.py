"""Put the benchmark's own directory and the checkout on the path, as
``benchmark/run.py`` does."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
