"""The benchmark's tests: run from the repository root with
``PYTHONPATH=src python -m pytest h100_bench/tests`` (the card's tests, marked
``gpu``, skip without a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
