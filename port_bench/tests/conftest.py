"""The benchmark's CPU tests: the reference against known values, the
frozen work counts against the program's launches, and rehearsals of
every cell on the CPU at small sizes. A test that needs the card is
marked ``card`` and skips without one (decided inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
