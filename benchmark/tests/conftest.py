"""The benchmark's own CPU tests (`python -m pytest benchmark/tests`):
the checkout's root on the import path, so `benchmark` and the port
import as a run imports them."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
