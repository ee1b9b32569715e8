import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (~1 min each)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
