"""The benchmark's own tests, on the CPU at small sizes.

Registers the ``gpu`` marker: tests that need an NVIDIA card decide inside
the ``cuda`` fixture whether there is one, and skip with a reason where
there is none (run them with ``pytest -m gpu gjbench/tests`` on a machine
that has one).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# per configuration: sizes small enough for the CPU
SMALL = {"lastfm_hetrec2k": dict(n_users=60, n_artists=80,
                                 user_artists=310, friends_per_user=3),
         "tpch_sf1": dict(scale_factor=0.002)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips with a reason without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
