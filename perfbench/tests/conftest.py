"""The benchmark's own tests: on the CPU at small sizes, except those
marked ``card``, which skip (deciding inside the test) without a CUDA
card. Run from the root of the repository:

    python -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")
