"""The grouped expert-MLP kernel (``csrc/expert_mlp.cu``), its gradient
(``csrc/expert_mlp_bwd.cu``) and their plain versions.

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

:class:`ExpertMLPFn` gives the forward a gradient: it saves x, the weights
and the counts (not h) and its backward is :func:`expert_mlp_bwd`, one
launch of the gradient kernel on the card (counted in
``expert_mlp_bwd.launches`` and ``.route_launches``, the route
:func:`..plan.expert_bwd_route` picks) and
:func:`~.ref.expert_mlp_bwd_plain` on the CPU.  :func:`expert_mlp` takes
it where autograd records a graph and an operand needs a gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import (expert_bwd_route, expert_bwd_scratch_elems,
                    expert_bwd_tiles, expert_bwd_work_words, expert_list_len,
                    expert_route)
from .ref import _lift, expert_mlp_bwd_plain, live_rows

__all__ = ["ExpertMLPFn", "expert_mlp", "expert_mlp_bwd",
           "expert_mlp_bwd_plain", "expert_mlp_plain",
           "live_rows", "rank_strided"]


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


def _check_operands(what, x, wg, wu, wd, counts):
    """The wrappers' shared checks; returns ``(G, S, E, C, d, f, counts)``
    with the counts made contiguous."""
    tensors = (x, wg, wu, wd)
    if any(t.device != x.device or t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{what}: x and the weights must share one "
                        "device and dtype")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes f32/f16/bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous rows")
    E, d, f = wg.shape[-3:]
    W = tuple(wg.shape[:-3])
    if wu.shape != wg.shape or tuple(wd.shape) != (*W, E, f, d) \
            or x.dim() < len(W) + 3 or tuple(x.shape[:len(W)]) != W \
            or tuple(x.shape[-3:-2]) != (E,) or x.shape[-1] != d:
        raise ValueError(f"{what} shapes x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if counts is not None:
        if counts.dtype != torch.int32 or counts.device != x.device \
                or tuple(counts.shape) != tuple(x.shape[:-2]):
            raise ValueError(f"{what} counts {tuple(counts.shape)} "
                             f"{counts.dtype}: need int32 {tuple(x.shape[:-2])}")
        counts = counts.contiguous()
    return (math.prod(W), math.prod(x.shape[len(W):-3]), E, x.shape[-2], d,
            f, counts)


def expert_mlp(x, wg, wu, wd, counts: Optional[torch.Tensor] = None):
    """The grouped expert MLP: on the card one call of the CUDA kernel
    (counted in ``expert_mlp.launches``), on the CPU its plain version;
    through :class:`ExpertMLPFn` where autograd records a graph and an
    operand needs a gradient (its forward, run without one, comes back
    here)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, wg, wu, wd)):
        return ExpertMLPFn.apply(x, wg, wu, wd, counts)
    if not x.is_cuda:
        return expert_mlp_plain(x, wg, wu, wd, counts)
    G, S, E, C, d, f, counts = _check_operands("expert_mlp", x, wg, wu, wd,
                                               counts)
    cptr = 0 if counts is None else counts.data_ptr()
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


def expert_mlp_bwd(x, wg, wu, wd, dy, counts: Optional[torch.Tensor] = None):
    """The expert MLP's gradient ``(dx, dwg, dwu, dwd)`` for the cotangent
    ``dy``: on the card one call of ``csrc/expert_mlp_bwd.cu`` (counted in
    ``expert_mlp_bwd.launches``, and by route in ``.route_launches``), on
    the CPU :func:`~.ref.expert_mlp_bwd_plain`.  dx comes out like x, each
    dW contiguous in its weight's shape, all in x's dtype."""
    if not x.is_cuda:
        return expert_mlp_bwd_plain(x, wg, wu, wd, dy, counts)
    G, S, E, C, d, f, counts = _check_operands("expert_mlp_bwd", x, wg, wu,
                                               wd, counts)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"expert_mlp_bwd dy {tuple(dy.shape)} {dy.dtype}: "
                         f"need x's {tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    cptr = 0 if counts is None else counts.data_ptr()
    dx = torch.empty_like(x)
    dwg = torch.empty(wg.shape, dtype=x.dtype, device=x.device)
    dwu = torch.empty(wu.shape, dtype=x.dtype, device=x.device)
    dwd = torch.empty(wd.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx, dwg.zero_(), dwu.zero_(), dwd.zero_()
    (wg, sg), (wu, su), (wd, sd) = (rank_strided(w) for w in (wg, wu, wd))
    isz = x.element_size()
    # the tensor cores read the weights by TMA (their rank strides in
    # bytes) and x and dy 16 bytes a lane
    route = expert_bwd_route(x.dtype, d, f, x.data_ptr(), dy.data_ptr(),
                             wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                             sg * isz, su * isz, sd * isz)
    if route == "wgmma":
        # each expert's live rows over the S sources packed in 64-row
        # tiles (x and dy, then dg, du and h), the metadata built on the
        # card from the counts
        tiles = expert_bwd_tiles(G * E, S, C)
        scratch = torch.empty(expert_bwd_scratch_elems(tiles, d, f),
                              dtype=x.dtype, device=x.device)
        work = torch.empty(expert_bwd_work_words(G * E, S, tiles),
                           dtype=torch.int32, device=x.device)
    else:                   # dg, du and h of every row
        tiles = 0
        scratch = torch.empty(3, G * S * E * C * f, dtype=x.dtype,
                              device=x.device)
        work = torch.empty(0, dtype=torch.int32, device=x.device)
    status = library("expert_mlp_bwd").repro_expert_mlp_bwd(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        dy.data_ptr(), cptr, dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
        dwd.data_ptr(), scratch.data_ptr(), work.data_ptr(), sg, su, sd, G,
        S, E, C, d, f, tiles, DTYPE_CODES[x.dtype], ROUTE_CODES[route],
        stream_handle(x.device))
    expert_mlp_bwd.launches += 1
    expert_mlp_bwd.route_launches[route] += 1
    check_launch(status, "expert_mlp_bwd")
    return dx, dwg, dwu, dwd


expert_mlp_bwd.launches = 0
expert_mlp_bwd.route_launches = dict.fromkeys(ROUTE_CODES, 0)


class ExpertMLPFn(torch.autograd.Function):
    """The grouped expert MLP with a gradient: the forward kernel (row 7),
    then the gradient kernel (row 12); on CPU tensors their plain
    versions.  Saves x, the weights and the counts; h is recomputed."""

    @staticmethod
    def forward(fctx, x, wg, wu, wd, counts):
        fctx.save_for_backward(x, wg, wu, wd, counts)
        return expert_mlp(x, wg, wu, wd, counts)

    @staticmethod
    def backward(fctx, dy):
        x, wg, wu, wd, counts = fctx.saved_tensors
        dx, dwg, dwu, dwd = expert_mlp_bwd(x, wg, wu, wd,
                                           dy.to(x.dtype).contiguous(),
                                           counts)
        need = fctx.needs_input_grad
        return (dx if need[0] else None, dwg if need[1] else None,
                dwu if need[2] else None, dwd if need[3] else None, None)

