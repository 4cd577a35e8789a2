"""The benchmark's own tests (run on the CPU with
`python -m pytest benchmark/tests -q`; those that need a card skip
inside the test without one)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
