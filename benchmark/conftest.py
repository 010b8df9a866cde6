"""pytest settings of the benchmark's own tests (benchmark/tests):

    python -m pytest benchmark/tests -q

The harness and the frozen reference are put on the path, and the
`card` marker is registered: a test that needs a CUDA device carries it
and skips on the CPU, deciding inside the test."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on the CPU")
