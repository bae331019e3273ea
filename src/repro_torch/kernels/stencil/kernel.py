"""The 25-point wave-step kernel (``csrc/wave_step.cu``) and its wrappers.

Replaces ``wave_step_pallas`` (``repro/kernels/stencil/kernel.py:65``,
``pallas_call`` at :80).  Its core is :func:`leap`, the counterpart of the
fused step's ``_leap`` (``repro/kernels/stencil/fused.py:101``): one
leapfrog update of the core of already halo-extended slabs.
``wave_step_kernel = leap(pad(u))``, and the fused emulation calls
:func:`leap` for its interior and boundary passes, so the Minimod time loop
runs this kernel on the card.  A launch takes the route
:func:`..plan.stencil_route` picks (counted in ``leap.route_launches``):
the ring of plane tiles fed by TMA for f32 operands with X a multiple of 4
and 16-byte-aligned pointers and strides (Minimod's every launch), the
CUDA-core tile otherwise.  What bounds it and how its design answers is
noted in ``csrc/wave_step.cu``.  On CPU tensors both wrappers compute the
plain version, :func:`leap_plain`.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from .._build import check_launch, library, stream_handle
from ..plan import STENCIL_ROUTES, default_planner, stencil_route
from .ref import COEFFS, RADIUS

__all__ = ["leap", "leap_plain", "wave_step_kernel"]

C2 = Union[float, torch.Tensor]
_MAX_GRID_Z = 65535


def leap_plain(uext: torch.Tensor, prev: torch.Tensor, c2: C2, *,
               dx: float = 1.0) -> torch.Tensor:
    """Plain version of :func:`leap`, term for term the reference's
    ``_leap`` (the same arithmetic order as ``wave_step_ref``)."""
    R = RADIUS
    bz, by, bx = (s - 2 * R for s in uext.shape[-3:])
    zc, yc, xc = slice(R, R + bz), slice(R, R + by), slice(R, R + bx)
    center = uext[..., zc, yc, xc]
    c0, *cs = COEFFS
    lap = 3.0 * c0 * center
    for r, c in zip(range(1, R + 1), cs):
        lap = lap + c * (uext[..., R - r:R - r + bz, yc, xc]
                         + uext[..., R + r:R + r + bz, yc, xc])
        lap = lap + c * (uext[..., zc, R - r:R - r + by, xc]
                         + uext[..., zc, R + r:R + r + by, xc])
        lap = lap + c * (uext[..., zc, yc, R - r:R - r + bx]
                         + uext[..., zc, yc, R + r:R + r + bx])
    lap = lap / (dx * dx)
    return (2.0 * center - prev + c2 * lap).to(prev.dtype)


def _batched(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as (B, Z, Y, X) without a copy (its leading dims flattened)."""
    if t.stride(-1) != 1:
        raise ValueError(f"leap: {what} must have unit stride along X")
    try:
        return t.view(-1, *t.shape[-3:])
    except RuntimeError:
        raise ValueError(
            f"leap: {what} of shape {tuple(t.shape)} and strides "
            f"{t.stride()} cannot flatten its leading dims without a copy"
        ) from None


def leap(uext: torch.Tensor, prev: torch.Tensor, c2: C2, *, dx: float = 1.0,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = 2u - prev + c2·lap(u)/dx²`` on the core of ``uext``.

    ``uext (..., Z+2R, Y+2R, X+2R)`` carries R planes of halo on every
    side; ``prev``, ``out`` and a tensor ``c2`` are ``(..., Z, Y, X)``; any
    of them may be a slice of a larger tensor (unit X stride).  The result
    is written into ``out`` when given (the port's in-place path: the fused
    step writes each pass straight into its output's slice).  The Z chunk a
    block walks is the active planner's ``plan_stencil_bz`` for this pass
    and route.
    """
    R = RADIUS
    Z, Y, X = prev.shape[-3:]
    if tuple(uext.shape[-3:]) != (Z + 2 * R, Y + 2 * R, X + 2 * R) \
            or uext.shape[:-3] != prev.shape[:-3]:
        raise ValueError(f"leap: uext {tuple(uext.shape)} is not prev "
                         f"{tuple(prev.shape)} plus a {R}-wide halo")
    if isinstance(c2, torch.Tensor) and c2.shape != prev.shape:
        raise ValueError(f"leap: c2 {tuple(c2.shape)} vs prev "
                         f"{tuple(prev.shape)}")
    if out is not None and out.shape != prev.shape:
        raise ValueError(f"leap: out {tuple(out.shape)} vs prev "
                         f"{tuple(prev.shape)}")
    if not uext.is_cuda:
        res = leap_plain(uext, prev, c2, dx=dx)
        return res if out is None else out.copy_(res)
    tensors = [uext, prev] + ([c2] if isinstance(c2, torch.Tensor) else []) \
        + ([out] if out is not None else [])
    if any(t.device != uext.device or t.dtype != torch.float32
           for t in tensors):
        raise TypeError("leap kernel takes float32 tensors on one device")
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    u4, p4, o4 = _batched(uext, "uext"), _batched(prev, "prev"), \
        _batched(out, "out")
    B = u4.shape[0]
    operands = [u4, p4, o4]
    if isinstance(c2, torch.Tensor):
        c4 = _batched(c2, "c2")
        cptr, cs, c2s = c4.data_ptr(), c4.stride()[:3], 0.0
        operands.append(c4)
    else:
        cptr, cs, c2s = None, (0, 0, 0), float(c2)
    route = stencil_route(torch.float32, X, *(
        v for t in operands
        for v in (t.data_ptr(), *(4 * s for s in t.stride()[:3]))))
    bz = default_planner().plan_stencil_bz(Z, Y, X, torch.float32, radius=R,
                                           route=route)
    bz = max(bz, math.ceil(B * Z / _MAX_GRID_Z))   # keep the grid legal
    status = library("wave_step").repro_leap(
        u4.data_ptr(), *u4.stride()[:3], p4.data_ptr(), *p4.stride()[:3],
        cptr, *cs, c2s, o4.data_ptr(), *o4.stride()[:3],
        B, Z, Y, X, bz, float(dx * dx), STENCIL_ROUTES.index(route),
        stream_handle(uext.device))
    leap.launches += 1
    leap.route_launches[route] += 1
    check_launch(status, "leap")
    return out


leap.launches = 0
leap.route_launches = dict.fromkeys(STENCIL_ROUTES, 0)


def wave_step_kernel(u: torch.Tensor, u_prev: torch.Tensor, c2dt2: C2, *,
                     dx: float = 1.0) -> torch.Tensor:
    """One leapfrog step with zero Dirichlet halos: ``leap(pad(u))``."""
    R = RADIUS
    return leap(F.pad(u, (R, R, R, R, R, R)), u_prev, c2dt2, dx=dx)
