"""Tests of the benchmark harness: ``python -m pytest perfbench/tests``
from the root of the repository.  Tests marked ``gpu`` need a CUDA card
and skip themselves elsewhere; run them on the card with ``python3 -m
pytest -p no:cacheprovider perfbench/tests -m gpu``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "gpu: needs an NVIDIA GPU; the test skips itself where "
      "torch.cuda.is_available() is false")
