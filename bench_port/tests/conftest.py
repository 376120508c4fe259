"""The benchmark's tests: python -m pytest bench_port/tests -q

They run on the CPU; those marked `cuda` need a card and skip without one
(python -m pytest bench_port/tests -q -m cuda on the card)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
