"""pytest settings of the benchmark's own tests (``benchmark/tests``):
the harness's directory and the repository root on the import path, and
the ``gpu`` marker of tests that need a CUDA card, which decide in their
body and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test decides in its body "
                   "and skips without one")
