"""The blocked matmul kernel (``csrc/matmul.cu``) and its wrapper.

Replaces ``matmul_pallas`` (``repro/kernels/ring_matmul/kernel.py:39``,
``pallas_call`` at :54).  What bounds it on the H100 and what its design
does about that is noted in ``csrc/matmul.cuh``.  Each launch takes the
route :func:`..plan.gemm_route` picks (the tensor cores for aligned 16-bit
operands, the CUDA cores otherwise) and counts it in
``matmul_kernel.route_launches``.  On a CPU tensor the wrapper computes the
plain version, :func:`.ref.matmul_ref`.
"""

from __future__ import annotations

import torch

from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import gemm_route
from .ref import matmul_ref

__all__ = ["matmul_kernel"]


def matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., M, K) @ w (..., K, N)`` with an f32 accumulator, output in
    ``x.dtype``; leading dims must match and each is one launch."""
    if not x.is_cuda:
        return matmul_ref(x, w)
    if x.device != w.device or x.dtype != w.dtype:
        raise ValueError(f"matmul: x on {x.device}/{x.dtype}, w on "
                         f"{w.device}/{w.dtype}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"matmul kernel takes f32/f16/bf16, got {x.dtype}")
    if x.dim() < 2 or x.shape[:-2] != w.shape[:-2] or x.shape[-1] != w.shape[-2]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous operands")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if min(M, K, N) < 1:
        raise ValueError(f"matmul with an empty dimension: {M}x{K}x{N}")
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    lib = library("matmul")
    stream = stream_handle(x.device)
    for xb, wb, ob in zip(x.reshape(-1, M, K), w.reshape(-1, K, N),
                          out.view(-1, M, N)):
        route = gemm_route(x.dtype, K, N, xb.data_ptr(), wb.data_ptr())
        status = lib.repro_matmul(xb.data_ptr(), wb.data_ptr(), ob.data_ptr(),
                                  M, N, K, DTYPE_CODES[x.dtype],
                                  ROUTE_CODES[route], stream)
        matmul_kernel.launches += 1
        matmul_kernel.route_launches[route] += 1
        check_launch(status, "matmul")
    return out


matmul_kernel.launches = 0
matmul_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
