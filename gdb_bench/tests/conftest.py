"""The benchmark's own tests: `python -m pytest gdb_bench/tests` (CPU;
the card's tests, marked `gpu`, skip without a card)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on an NVIDIA card (skips without one; "
                   "select with -m gpu)")
