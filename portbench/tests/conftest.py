"""Settings of the benchmark's own tests: the checkout's root on the
path, and the ``gpu`` marker for tests that need a CUDA card (they skip
inside the test without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips inside the test "
        "without one")
