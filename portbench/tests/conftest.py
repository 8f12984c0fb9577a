"""The benchmark's own tests (CPU here; those marked ``cuda`` need a card).

    python -m pytest portbench/tests

Imports nothing of JAX: tests/conftest.py, which does, is not on this path.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (inside the test) where there is none")
