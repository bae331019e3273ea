"""Public linear scan (the reference's ``linear_scan``, ops.py:20).

The hand-written kernel on CUDA tensors, for every T (T = 1 at decode
included) and for a zero or carried ``s0``, and the plain version (the
sequential scan) on CPU tensors.  The reference's ``impl`` and
``interpret`` options are not taken, so no caller reaches the plain
version on the card.
"""

from __future__ import annotations

from ..plan import SCAN_CHUNK
from .kernel import linear_scan_kernel

__all__ = ["linear_scan"]


def linear_scan(p, q, a, r, s0=None, *, readout_pre: bool = True,
                chunk: int = SCAN_CHUNK):
    """p: (BH, T, M); q, a, r: (BH, T, N); s0: (BH, M, N) or None (zeros).

    Returns (y: (BH, T, M) in p.dtype, s_final: (BH, M, N) f32).
    """
    return linear_scan_kernel(p, q, a, r, s0, readout_pre=readout_pre,
                              chunk=chunk)
