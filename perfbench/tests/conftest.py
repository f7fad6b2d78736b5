"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository (the card's: ``-m cuda``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
