"""The benchmark's own tests (run as `python -m pytest -q perfbench/tests`
from the root of the checkout; the repository's suite under tests/ does
not collect them). Puts perfbench/ and src/ on the import path, and
keeps torch to two threads here and in the runs the tests start: the
tiny rehearsals' windows are seconds of wall clock, and on a shared CPU
more threads than that made their steps ten times slower at times.
"""
import os
import sys
from pathlib import Path

import torch

os.environ["OMP_NUM_THREADS"] = "2"
torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
