"""Tests of the benchmark: `python -m pytest portbench/tests` (their own
pytest.ini; no JAX).  Tests marked `card` need a CUDA card, decide so
inside themselves and skip elsewhere; on the card they run the cells at
their own sizes (~10 min)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
