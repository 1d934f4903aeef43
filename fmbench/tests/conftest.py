"""The benchmark's own tests (``python -m pytest fmbench/tests``): CPU only,
except those marked ``gpu``, which skip without a CUDA device."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
