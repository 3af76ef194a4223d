"""The benchmark's own tests: `python -m pytest cosine_bench/tests` from
the root of the repository (the repository's test run, `tests/`, does not
collect them). They put the checkout's root and `src/` on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
