"""Put the benchmark's own directory and the checkout on the path, as
``benchmark/run.py`` does."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


import pytest  # noqa: E402


@pytest.fixture
def few_threads(monkeypatch):
    """Ranks spawned on the CPU take two threads each, not every core apiece."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
