"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that decide inside a fixture whether a card is there."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")
    return torch.device("cuda", 0)
