"""The grouped expert-MLP kernel (``csrc/expert_mlp.cu``) and its plain
version.

Replaces ``expert_mlp_pallas`` (``repro/kernels/moe_dispatch/kernel.py:35``,
``pallas_call`` at :44): ``(silu(x @ wg) * (x @ wu)).astype(x) @ wd`` with
f32 accumulation, one weight set an expert.  What bounds it on the H100
and what its design does about that is noted in ``csrc/expert_mlp.cuh``.

Layout: ``x (*W, *S, E, C, d)``, ``wg/wu (*W, E, d, f)``, ``wd (*W, E, f,
d)``; the weights' leading dims ``W`` (ranks) lead x's, and the dims ``S``
between them and ``E`` (sources of a landed all-to-all) share the
weights.  ``counts (*W, *S, E)`` int32, optional, is each expert's live
rows: rows at or past it come out as zeros and no product is computed for
them.  That is exact where those input rows are zero, as the dispatch
layouts leave them: for a zero row ``silu(0)·0 @ wd = 0``.

On the card the launch takes the route :func:`..plan.expert_route` picks
(counted in ``expert_mlp.route_launches``): the tensor cores for aligned
f16/bf16 with d and f multiples of 64, the CUDA cores otherwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import expert_list_len, expert_route

__all__ = ["expert_mlp", "expert_mlp_plain", "live_rows", "rank_strided"]


def _lift(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weights ``(*W, E, a, b)`` viewed to broadcast against x's dims."""
    extra = x.dim() - w.dim()
    return w.reshape(*w.shape[:-3], *([1] * extra), *w.shape[-3:])


def rank_strided(w: torch.Tensor):
    """``w (*lead, E, a, b)`` as ``(G, E, a, b)`` with each rank's experts
    contiguous, and the elements from one rank's to the next: one layer of
    a stacked weight passes as a view, without a copy; a layout that is
    not one uniform stride is copied."""
    E, a, b = w.shape[-3:]
    try:
        v = w.view(-1, E, a, b)
    except RuntimeError:
        v = w.contiguous().view(-1, E, a, b)
    if v.stride()[1:] != (a * b, b, 1):
        v = v.contiguous()
    return v, (v.stride(0) if v.shape[0] > 1 else E * a * b)


def live_rows(counts: torch.Tensor, C: int) -> torch.Tensor:
    """``(..., E, C)`` mask of the rows below each expert's count."""
    return torch.arange(C, device=counts.device) < counts[..., None]


def expert_mlp_plain(x, wg, wu, wd, counts: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch, in the Pallas kernel's
    precision: ``g`` and ``u`` in f32, ``h = silu(g)·u`` rounded to x's
    dtype, ``h @ wd`` in f32 and cast."""
    xf = x.float()
    g = torch.matmul(xf, _lift(wg, x).float())
    u = torch.matmul(xf, _lift(wu, x).float())
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.matmul(h.float(), _lift(wd, x).float()).to(x.dtype)
    if counts is not None:
        y = y.masked_fill(~live_rows(counts, x.shape[-2])[..., None], 0)
    return y


def expert_mlp(x, wg, wu, wd, counts: Optional[torch.Tensor] = None):
    """The grouped expert MLP: on the card one call of the CUDA kernel
    (counted in ``expert_mlp.launches``), on the CPU its plain version."""
    if not x.is_cuda:
        return expert_mlp_plain(x, wg, wu, wd, counts)
    tensors = (x, wg, wu, wd)
    if any(t.device != x.device or t.dtype != x.dtype for t in tensors):
        raise TypeError("expert_mlp: x and the weights must share one "
                        "device and dtype")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"expert_mlp takes f32/f16/bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expert_mlp takes contiguous rows")
    E, d, f = wg.shape[-3:]
    W = tuple(wg.shape[:-3])
    if wu.shape != wg.shape or tuple(wd.shape) != (*W, E, f, d) \
            or x.dim() < len(W) + 3 or tuple(x.shape[:len(W)]) != W \
            or tuple(x.shape[-3:-2]) != (E,) or x.shape[-1] != d:
        raise ValueError(f"expert_mlp shapes x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    C = x.shape[-2]
    G = math.prod(W)
    S = math.prod(x.shape[len(W):-3])
    cptr = 0
    if counts is not None:
        if counts.dtype != torch.int32 or counts.device != x.device \
                or tuple(counts.shape) != tuple(x.shape[:-2]):
            raise ValueError(f"expert_mlp counts {tuple(counts.shape)} "
                             f"{counts.dtype}: need int32 {tuple(x.shape[:-2])}")
        counts = counts.contiguous()
        cptr = counts.data_ptr()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    (wg, sg), (wu, su), (wd, sd) = (rank_strided(w) for w in (wg, wu, wd))
    h = torch.empty(G * S * E * C * f, dtype=x.dtype, device=x.device)
    isz = x.element_size()
    # TMA reads x, the weights (their rank strides in bytes) and h
    route = expert_route(x.dtype, d, f, x.data_ptr(), wg.data_ptr(),
                         wu.data_ptr(), wd.data_ptr(), h.data_ptr(),
                         sg * isz, su * isz, sd * isz)
    work = torch.empty(expert_list_len(G * S * E, C) if route == "wgmma"
                       else 0, dtype=torch.int32, device=x.device)
    status = library("expert_mlp").repro_expert_mlp(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), cptr,
        out.data_ptr(), h.data_ptr(), work.data_ptr(), sg, su, sd, G, S, E,
        C, d, f, DTYPE_CODES[x.dtype], ROUTE_CODES[route],
        stream_handle(x.device))
    expert_mlp.launches += 1
    expert_mlp.route_launches[route] += 1
    check_launch(status, "expert_mlp")
    return out


expert_mlp.launches = 0
expert_mlp.route_launches = dict.fromkeys(ROUTE_CODES, 0)
