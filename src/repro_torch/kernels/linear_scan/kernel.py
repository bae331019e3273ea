"""The chunked linear-scan kernel (``csrc/linear_scan.cu``) and its wrapper.

Replaces ``linear_scan_pallas`` (``repro/kernels/linear_scan/kernel.py:89``,
``pallas_call`` at :104).  It computes :func:`.ref.linear_scan_ref` at any
decay: unlike the Pallas kernel it never clamps, since every exponent it
takes is a difference of cumulative log-decays that is at most zero (the
CUDA source says why the clamp is wrong and what bounds the kernel).  On
CPU tensors the wrapper computes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check_launch, library, stream_handle
from .ref import linear_scan_ref

__all__ = ["linear_scan_kernel", "linear_scan_plain", "MAX_CHUNK", "MAX_DIM"]

MAX_CHUNK = 64   # rows of a chunk the kernel stages
MAX_DIM = 64     # largest M and N it takes


def linear_scan_plain(p, q, a, r, s0=None, *, readout_pre: bool = True):
    """The plain version: the sequential scan, ``s0=None`` meaning zeros."""
    if s0 is None:
        s0 = torch.zeros(p.shape[0], p.shape[-1], q.shape[-1],
                         dtype=torch.float32, device=p.device)
    return linear_scan_ref(p, q, a, r, s0, readout_pre=readout_pre)


def linear_scan_kernel(p, q, a, r, s0: Optional[torch.Tensor] = None, *,
                       readout_pre: bool = True, chunk: int = MAX_CHUNK):
    """``p (BH, T, M)``; ``q, a, r (BH, T, N)``; ``s0 (BH, M, N)`` or None
    (zeros) -> ``(y (BH, T, M) in p.dtype, s_final (BH, M, N) f32)``.

    On the card every operand must be contiguous f32 on one device, with
    M, N <= 64 and ``chunk`` <= 64; any T >= 1 is taken (a ragged last
    chunk is masked, T = 1 is a decode step).  One launch a call.
    """
    BH, T, M = p.shape
    N = q.shape[-1]
    if q.shape != (BH, T, N) or a.shape != q.shape or r.shape != q.shape \
            or (s0 is not None and s0.shape != (BH, M, N)):
        raise ValueError(f"linear scan shapes p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}, a {tuple(a.shape)}, r "
                         f"{tuple(r.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if not p.is_cuda:
        return linear_scan_plain(p, q, a, r, s0, readout_pre=readout_pre)
    ops = (p, q, a, r) + (() if s0 is None else (s0,))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != p.device for t in ops):
        got = ", ".join(
            f"{t.dtype}{'' if t.is_contiguous() else ' strided'} on "
            f"{t.device}" for t in ops)
        raise TypeError(f"linear scan kernel takes contiguous float32 "
                        f"operands on one device, got {got}")
    if M > MAX_DIM or N > MAX_DIM or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"linear scan kernel takes M, N <= {MAX_DIM} and a "
                         f"chunk of 1..{MAX_CHUNK}, got M {M}, N {N}, chunk "
                         f"{chunk}")
    y = torch.empty(BH, T, M, dtype=torch.float32, device=p.device)
    s_fin = torch.empty(BH, M, N, dtype=torch.float32, device=p.device)
    status = library("linear_scan").repro_linear_scan(
        p.data_ptr(), q.data_ptr(), a.data_ptr(), r.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
        BH, T, M, N, min(chunk, T), int(readout_pre),
        stream_handle(p.device))
    linear_scan_kernel.launches += 1
    check_launch(status, "linear scan")
    return y, s_fin


linear_scan_kernel.launches = 0
