"""Registers the ``gpu`` marker: tests that need an NVIDIA card.

They skip with a reason where no card is present (run them with
``pytest -m gpu tests/test_torch_gpu.py`` on a machine that has one).
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips with a reason without one")
