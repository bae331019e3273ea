"""Public linear scan (the reference's ``linear_scan``, ops.py:20).

The hand-written kernel on CUDA tensors, for every T (T = 1 at decode
included) and for a zero or carried ``s0``, and the plain version (the
sequential scan) on CPU tensors, where autograd differentiates it.  On the
card a call that needs a gradient goes through :class:`.kernel.
LinearScanFn`: the forward kernel, then the backward kernel.  The decay is
given as ``a`` or as its logarithm ``log_a``; on the card a gradient
through the scan takes ``log_a`` (the models pass it), since ``da =
dla / a`` has no finite value where a underflows.  The reference's
``impl`` and ``interpret`` options are not taken, so no caller reaches the
plain version on the card.
"""

from __future__ import annotations

import torch

from ..plan import SCAN_CHUNK
from .kernel import LinearScanFn, linear_scan_kernel

__all__ = ["linear_scan"]


def linear_scan(p, q, a, r, s0=None, *, log_a=None, readout_pre: bool = True,
                chunk: int = SCAN_CHUNK):
    """p: (BH, T, M); q, a (or log_a), r: (BH, T, N); s0: (BH, M, N) or
    None (zeros).  Exactly one of ``a`` and ``log_a`` is given.

    Returns (y: (BH, T, M) in p.dtype, s_final: (BH, M, N) f32).
    """
    if (a is None) == (log_a is None):
        raise TypeError("linear_scan takes one of a and log_a")
    ops = (p, q, a, log_a, r, s0)
    if p.is_cuda and torch.is_grad_enabled() \
            and any(t is not None and t.requires_grad for t in ops):
        if log_a is None:
            raise TypeError("on the card a gradient through the scan takes "
                            "the decay as log_a")
        return LinearScanFn.apply(p, q, log_a, r, s0, readout_pre, chunk)
    if a is None:
        a = torch.exp(log_a)
    return linear_scan_kernel(p, q, a, r, s0, readout_pre=readout_pre,
                              chunk=chunk)
