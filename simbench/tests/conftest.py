"""Make the repository's root (for `simbench`) and `src` (for the
program, `repro_torch`) importable, as `simbench/run.py` does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
