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


def test_ptxas_summary_reads_each_kernel_instance():
    """chip_smoke logs registers and spills per kernel instance from the
    build's ``-Xptxas -v`` output (runs without a card)."""
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aIfEvv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aIfEvv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 8192 bytes smem\n"
        "ptxas info    : Function properties for helper\n"
        "    8 bytes stack frame\n"
        "ptxas info    : Compiling entry function '_Z1bIfEvv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bIfEvv\n"
        "    24 bytes stack frame, 28 bytes spill stores, 44 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert list(chip_smoke.ptxas_summary(log)) == [
        ("_Z1aIfEvv", 80,
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("_Z1bIfEvv", 168,
         "24 bytes stack frame, 28 bytes spill stores, 44 bytes spill loads")]
