"""The benchmark's own tests (CPU; the ``cuda``-marked ones on the card):

    python -m pytest benchmark/tests -q                 # here
    python -m pytest benchmark/tests -q -m cuda         # on the card

They put the benchmark's folder and the checkout's root on the path, as
`run.py` does.  Whether there is a card is decided inside the ``card``
fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest benchmark/tests -m cuda)")
    return "cuda"
