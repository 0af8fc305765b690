"""The benchmark's own tests: on the CPU here, with the card tests marked
`cuda` and skipped, from inside a fixture, where no card is present.

    python -m pytest hevcbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the control runs there)")
    return "cuda"
