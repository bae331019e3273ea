"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The checks, their shapes and their tolerances are ``chip_smoke.py``'s
(``SMALL_CHECKS``); this file runs each as a test of its own.  It imports
no JAX, so it also runs where only the port is installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py``.  Without a CUDA device the tests skip.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(chip_smoke.SMALL_CHECKS))
def test_kernel_against_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.SMALL_CHECKS[name](torch, chip_smoke.load_port(), gen)
