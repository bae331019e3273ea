"""Fused halo-overlapped Minimod wave step (paper §4.5, Listings 1–2).

The halo exchange is one-sided puts and the step is split so the interior —
which needs no halo — computes under the in-flight exchange.  One schedule
(:meth:`repro_torch.kernels.plan.HaloPlan.schedule`), two executions over
stacked fields ``(nz, ny, Z, Y, X)`` (mesh axes ``z``, ``y``):

* :func:`fused_wave_step_kernel` — the CUDA kernel (``csrc/
  fused_wave_step.cu``, which replaces ``fused_wave_step_tpu``): every
  rank's step in one launch for a 1-D symmetric f32 Z ring, on either
  schedule: the single step (put, interior, fence, boundary) or the time
  loop's carried step (boundary, put, interior, fence), which also writes
  the next field's halos;
* :func:`fused_wave_step_emulated` — each remote copy an ``ompx_put``,
  every pass a :func:`~.kernel.leap` (the wave-step kernel on the card);
  covers what the fused kernel does not: 2-D (Z×Y) decomposition,
  asymmetric per-rank Z extents and 16-bit fields.

Carried halos (``return_halos=True``): the halos of the current field landed
during the previous step, so each step computes the R-thick boundary output
slabs first, puts them to the neighbours (they are the neighbours'
next-step halos), computes the interior under the exchange, and fences.
Every put is recorded against the active context's RMATracker halo windows
and the OMPCCL byte log alike.

Asymmetric extents: every rank's shard is padded to the largest extent and
``z_extents`` marks the valid rows; slabs are cut at each rank's valid edge
and invalid rows are kept at zero.

Across processes (a mesh split between the processes of a job) each
process steps its box of ranks: the puts cross through the data plane of
:mod:`repro_torch.core.coordination`, and on the card the carried step
runs as one launch over the box, the halos at the box's edges then
fetched from the neighbour processes (:func:`fused_step_route`).

In place: halos are written into the padded copy of the field, and every
pass writes straight into its slice of the step's output.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...core.backends import (crosses_processes, payload_bytes, ring_roll,
                              zero_rank)
from ...core.context import default_context
from ...core.groups import DiompGroup
from ...core.rma import RMAError, halo_window_names, ompx_fence, ompx_put
from .._build import check_launch, library, stream_handle
from ..plan import STENCIL_ROUTES, HaloPlan, default_planner, stencil_route
from .kernel import C2, leap
from .ref import RADIUS, wave_step_ref

__all__ = [
    "Halos",
    "exchange_halos",
    "fused_wave_step",
    "fused_wave_step_emulated",
    "fused_step_route",
    "fused_wave_step_carried_plain",
    "fused_wave_step_kernel",
    "fused_wave_step_plain",
]


class Halos(NamedTuple):
    """The four halo slabs of every shard (``None`` where the axis is whole).

    ``z_lo``/``z_hi`` are stacked (R, Y, X) slabs from the Z neighbours,
    ``y_lo``/``y_hi`` (Z, R, X) strips from the Y neighbours.
    """

    z_lo: Optional[torch.Tensor] = None
    z_hi: Optional[torch.Tensor] = None
    y_lo: Optional[torch.Tensor] = None
    y_hi: Optional[torch.Tensor] = None


def _put_slab(slab, group: DiompGroup, *, shift: int, window: str):
    """One-sided slab put, recorded against the tracker's halo window."""
    ctx = default_context()
    ctx.rma.ensure(window)
    mesh = ctx.require_mesh()
    ctx.rma.on_put(window, payload_bytes(slab, mesh.local_size))
    return ompx_put(slab, group, shift=shift)


def _sl(c2: C2, *idx) -> C2:
    """Slice a per-point c2 like the field; a scalar passes through."""
    return c2[(..., *idx)] if isinstance(c2, torch.Tensor) else c2


def _zslice(t: torch.Tensor, starts: Sequence[int], length: int):
    """Rows ``starts[iz] .. + length`` of every Z rank's shard (a view when
    every rank starts at the same row)."""
    if len(set(starts)) == 1:
        return t.narrow(-3, starts[0], length)
    return torch.stack([t[iz].narrow(-3, s, length)
                        for iz, s in enumerate(starts)])


def _local_extents(z_extents: Optional[Tuple[int, ...]],
                   zgroup: DiompGroup) -> Optional[Tuple[int, ...]]:
    """This process's entries of the per-Z-rank extents (all of them when
    the process holds the whole Z ring)."""
    if z_extents is None:
        return None
    mesh = default_context().require_mesh()
    return tuple(z_extents[mesh.box[zgroup.rank_dims(mesh)[0]]])


def _mask_valid(a: torch.Tensor, z_extents: Optional[Tuple[int, ...]]):
    """Zero every row at or beyond each rank's valid Z extent (padding rows
    of an asymmetric shard are other ranks' Dirichlet boundary)."""
    if z_extents is None:
        return a
    Z = a.shape[-3]
    zv = torch.tensor(z_extents, device=a.device).view(-1, 1, 1, 1, 1)
    keep = torch.arange(Z, device=a.device).view(1, 1, Z, 1, 1) < zv
    return torch.where(keep, a, torch.zeros((), dtype=a.dtype,
                                            device=a.device))


def _assemble(upad: torch.Tensor, halos: Halos, ext: Sequence[int]):
    """Place the landed halos into the zero-padded field, in place, at each
    rank's valid edge.  (The interior pass reads no halo row or column of
    any exchanging axis, so it may share this buffer.)"""
    R = RADIUS
    Z, Y, X = (s - 2 * R for s in upad.shape[-3:])
    if halos.z_lo is not None:
        upad[..., 0:R, R:Y + R, R:X + R] = halos.z_lo
        if len(set(ext)) == 1:
            upad[..., ext[0] + R:ext[0] + 2 * R, R:Y + R, R:X + R] = halos.z_hi
        else:
            for iz, e in enumerate(ext):
                upad[iz, ..., e + R:e + 2 * R, R:Y + R, R:X + R] = halos.z_hi[iz]
    if halos.y_lo is not None:
        upad[..., R:Z + R, 0:R, R:X + R] = halos.y_lo
        upad[..., R:Z + R, Y + R:Y + 2 * R, R:X + R] = halos.y_hi
    return upad


# ---------------------------------------------------------------------------
# halo exchange over one-sided puts (asymmetric- and 2-D-aware)
# ---------------------------------------------------------------------------


def _slabs_of(u, *, ext, z_extents, nz: int, ny: int):
    """(z_lo, z_hi, y_lo, y_hi) boundary slabs of a field, at the valid edge."""
    R = RADIUS
    Y = u.shape[-2]
    z_lo = z_hi = y_lo = y_hi = None
    if nz > 1:
        z_lo = u[..., 0:R, :, :]
        z_hi = _zslice(u, [e - R for e in ext], R)
    if ny > 1:
        y_lo = _mask_valid(u[..., :, 0:R, :], z_extents)
        y_hi = _mask_valid(u[..., :, Y - R:Y, :], z_extents)
    return z_lo, z_hi, y_lo, y_hi


def _halo_puts(slabs, zgroup: DiompGroup, ygroup: Optional[DiompGroup],
               *, nz: int, ny: int) -> Halos:
    """Issue the one-sided puts of a step; returns the (un-fenced) halos.

    Every put is a full-ring permute with the wrap-around edge zeroed after
    landing — non-periodic boundaries, as the kernels guard their windows.
    """
    mesh = default_context().require_mesh()
    z_lo = z_hi = y_lo = y_hi = None
    if nz > 1:
        d = zgroup.rank_dims(mesh)[0]
        lo_w, hi_w = halo_window_names(zgroup, 0)
        z_lo = _put_slab(slabs[1], zgroup, shift=1, window=lo_w)
        z_hi = _put_slab(slabs[0], zgroup, shift=-1, window=hi_w)
        zero_rank(z_lo, mesh, d, 0)
        zero_rank(z_hi, mesh, d, nz - 1)
    if ny > 1:
        d = ygroup.rank_dims(mesh)[0]
        lo_w, hi_w = halo_window_names(ygroup, 1)
        y_lo = _put_slab(slabs[3], ygroup, shift=1, window=lo_w)
        y_hi = _put_slab(slabs[2], ygroup, shift=-1, window=hi_w)
        zero_rank(y_lo, mesh, d, 0)
        zero_rank(y_hi, mesh, d, ny - 1)
    return Halos(z_lo, z_hi, y_lo, y_hi)


def _fence_halos(halos: Halos, zgroup: DiompGroup,
                 ygroup: Optional[DiompGroup]) -> Halos:
    """Complete the step's puts; advances the tracker's window epochs so the
    subsequent halo reads satisfy the put→fence→read discipline."""
    if not any(h is not None for h in halos):
        return halos
    ompx_fence(*(h for h in halos if h is not None))
    windows: List[str] = []
    if halos.z_lo is not None:
        windows += list(halo_window_names(zgroup, 0))
    if halos.y_lo is not None:
        windows += list(halo_window_names(ygroup, 1))
    tr = default_context().rma
    tr.on_fence(*windows)
    for w in windows:
        tr.on_read(w)
    return halos


def _sizes(zgroup: DiompGroup, ygroup: Optional[DiompGroup]):
    mesh = default_context().require_mesh()
    return (zgroup.axis_size(mesh),
            ygroup.axis_size(mesh) if ygroup is not None else 1)


def exchange_halos(u, zgroup: DiompGroup, ygroup: Optional[DiompGroup] = None,
                   *, z_extents: Optional[Tuple[int, ...]] = None) -> Halos:
    """One complete halo exchange of the current field (puts + one fence):
    the time loop's prologue and the whole exchange of the fallback plan.
    ``z_extents`` has an entry for every Z rank of the mesh."""
    return _exchange(u, zgroup, ygroup, _local_extents(z_extents, zgroup))


def _exchange(u, zgroup: DiompGroup, ygroup: Optional[DiompGroup],
              z_extents: Optional[Tuple[int, ...]]) -> Halos:
    """:func:`exchange_halos` with this process's entries of the extents."""
    nz, ny = _sizes(zgroup, ygroup)
    ext = z_extents or (u.shape[-3],) * nz
    slabs = _slabs_of(u, ext=ext, z_extents=z_extents, nz=nz, ny=ny)
    return _fence_halos(_halo_puts(slabs, zgroup, ygroup, nz=nz, ny=ny),
                        zgroup, ygroup)


# ---------------------------------------------------------------------------
# the emulation: the plan's phases over ompx_put, every pass a leap
# ---------------------------------------------------------------------------


def _boundary(uext, u_prev, c2, *, ext, z_extents, nz: int, ny: int,
              dx: float):
    """The R-thick boundary output slabs (phase "boundary" of the plan)."""
    R = RADIUS
    Y = u_prev.shape[-2]
    lo = hi = y_lo = y_hi = None
    if nz > 1:
        lo = leap(uext[..., 0:3 * R, :, :], u_prev[..., 0:R, :, :],
                  _sl(c2, slice(0, R), slice(None), slice(None)), dx=dx)
        starts = [e - R for e in ext]
        c2_hi = _zslice(c2, starts, R) if isinstance(c2, torch.Tensor) else c2
        hi = leap(_zslice(uext, starts, 3 * R), _zslice(u_prev, starts, R),
                  c2_hi, dx=dx)
    if ny > 1:
        y_lo = _mask_valid(leap(
            uext[..., :, 0:3 * R, :], u_prev[..., :, 0:R, :],
            _sl(c2, slice(None), slice(0, R), slice(None)), dx=dx), z_extents)
        y_hi = _mask_valid(leap(
            uext[..., :, Y - R:Y + 2 * R, :], u_prev[..., :, Y - R:Y, :],
            _sl(c2, slice(None), slice(Y - R, Y), slice(None)), dx=dx),
            z_extents)
    return lo, hi, y_lo, y_hi


def _interior(upad, u_prev, c2, out, *, nz: int, ny: int, dx: float):
    """The halo-independent interior (phase "interior"), written into
    ``out``: computed from the local field alone, so it runs entirely under
    the in-flight exchange."""
    R = RADIUS
    Z, Y = u_prev.shape[-3:-1]
    zsl = slice(R, Z + R) if nz > 1 else slice(0, Z + 2 * R)
    ysl = slice(R, Y + R) if ny > 1 else slice(0, Y + 2 * R)
    pz = slice(R, Z - R) if nz > 1 else slice(0, Z)
    py = slice(R, Y - R) if ny > 1 else slice(0, Y)
    leap(upad[..., zsl, ysl, :], u_prev[..., pz, py, :],
         _sl(c2, pz, py, slice(None)), dx=dx, out=out[..., pz, py, :])


def _combine(out, boundary, *, ext, z_extents):
    """Stitch the boundary passes into the output; invalid rows zeroed."""
    R = RADIUS
    Y = out.shape[-2]
    lo, hi, y_lo, y_hi = boundary
    if y_lo is not None:
        out[..., :, 0:R, :] = y_lo
        out[..., :, Y - R:Y, :] = y_hi
    if lo is not None:
        out[..., 0:R, :, :] = lo
        if len(set(ext)) == 1:
            out[..., ext[0] - R:ext[0], :, :] = hi
        else:
            for iz, e in enumerate(ext):
                out[iz, ..., e - R:e, :, :] = hi[iz]
    return _mask_valid(out, z_extents)


def fused_wave_step_emulated(
    u, u_prev, c2dt2: C2, zgroup: DiompGroup,
    ygroup: Optional[DiompGroup] = None, *,
    plan: HaloPlan, dx: float = 1.0, halos: Optional[Halos] = None,
    z_extents: Optional[Tuple[int, ...]] = None, return_halos: bool = False,
):
    """Execute :meth:`HaloPlan.schedule` with ``ompx_put`` as the remote copy.

    With ``return_halos=True`` the step returns ``(u_next, halos_of_u_next)``
    for the carried time loop.
    """
    R = plan.halo
    nz, ny = plan.nz, plan.ny
    Z = u.shape[-3]
    z_extents = _local_extents(z_extents, zgroup)
    ext = z_extents or (Z,) * nz
    u = _mask_valid(u, z_extents)
    u_prev = _mask_valid(u_prev, z_extents)
    upad = F.pad(u, (R, R, R, R, R, R))

    if halos is None and return_halos and plan.overlap:
        # entering the carried loop: prologue exchange of the current field
        halos = _exchange(u, zgroup, ygroup, z_extents)
    sched = plan.schedule(carried=halos is not None)

    if sched == ("all",):                      # no exchanging axis at all
        out = _mask_valid(leap(upad, u_prev, c2dt2, dx=dx), z_extents)
        return (out, None) if return_halos else out

    if sched == ("put", "fence", "all"):       # planner fallback: no overlap
        if halos is None:
            halos = _exchange(u, zgroup, ygroup, z_extents)
        uext = _assemble(upad, halos, ext)
        out = _mask_valid(leap(uext, u_prev, c2dt2, dx=dx), z_extents)
        # fallback halos are of the INPUT field — stale after the step, so
        # the time loop re-exchanges next step rather than carrying them
        return (out, None) if return_halos else out

    out = torch.zeros_like(u)
    if sched == ("put", "interior", "fence", "boundary"):
        # single step, no carried halos: exchange the current field's slabs
        # while the interior computes under it
        started = _halo_puts(
            _slabs_of(u, ext=ext, z_extents=z_extents, nz=nz, ny=ny),
            zgroup, ygroup, nz=nz, ny=ny)
        _interior(upad, u_prev, c2dt2, out, nz=nz, ny=ny, dx=dx)
        landed = _fence_halos(started, zgroup, ygroup)
        uext = _assemble(upad, landed, ext)
        bnd = _boundary(uext, u_prev, c2dt2, ext=ext, z_extents=z_extents,
                        nz=nz, ny=ny, dx=dx)
        out = _combine(out, bnd, ext=ext, z_extents=z_extents)
        return (out, None) if return_halos else out

    if sched != ("boundary", "put", "interior", "fence"):
        raise AssertionError(f"unknown schedule {sched}")
    # carried halos: boundary first (it has everything it needs), its fresh
    # values go straight onto the wire, the interior hides the transfer
    uext = _assemble(upad, halos, ext)
    bnd = _boundary(uext, u_prev, c2dt2, ext=ext, z_extents=z_extents,
                    nz=nz, ny=ny, dx=dx)
    started = _halo_puts(bnd, zgroup, ygroup, nz=nz, ny=ny)
    _interior(uext, u_prev, c2dt2, out, nz=nz, ny=ny, dx=dx)
    new_halos = _fence_halos(started, zgroup, ygroup)
    out = _combine(out, bnd, ext=ext, z_extents=z_extents)
    return (out, new_halos) if return_halos else out


# ---------------------------------------------------------------------------
# the CUDA kernel: one launch for every rank's step, single or carried
# ---------------------------------------------------------------------------


def fused_wave_step_plain(u, u_prev, c2dt2: C2, *, dx: float):
    """Plain version of the fused kernel's single step: the ranks' shards
    are consecutive Z slabs of one grid, so the step is the single-grid
    oracle on it."""
    nz, ny, Z, Y, X = u.shape
    whole = (nz * Z, Y, X)
    c2 = c2dt2.reshape(whole) if isinstance(c2dt2, torch.Tensor) else c2dt2
    return wave_step_ref(u.reshape(whole), u_prev.reshape(whole), c2,
                         dx=dx).reshape(u.shape)


def fused_wave_step_carried_plain(u, u_prev, c2dt2: C2, halos: Halos, *,
                                  dx: float):
    """Plain version of the fused kernel's carried step on stacked
    ``(nz, 1, Z, Y, X)`` fields: each rank's slab is assembled with the
    given halos (``z_lo``/``z_hi``, ``(nz, 1, R, Y, X)``), the single-grid
    oracle runs on it, and the next field's halos are the neighbours'
    boundary output rows, zero where the ring wraps.  Returns ``(out,
    Halos(z_lo, z_hi, None, None))``."""
    R = RADIUS
    Z = u.shape[-3]
    rows = (0, 0, 0, 0, R, R)                   # R zero rows above and below
    slab = torch.cat([halos.z_lo, u, halos.z_hi], dim=-3)
    c2 = F.pad(c2dt2, rows) if isinstance(c2dt2, torch.Tensor) else c2dt2
    out = wave_step_ref(slab, F.pad(u_prev, rows), c2,
                        dx=dx)[..., R:R + Z, :, :].contiguous()
    z_lo = torch.roll(out[..., Z - R:Z, :, :], 1, dims=0)
    z_hi = torch.roll(out[..., 0:R, :, :], -1, dims=0)
    z_lo[0] = 0
    z_hi[-1] = 0
    return out, Halos(z_lo, z_hi, None, None)


def operand_route(X: int, tensors) -> str:
    """The route of a fused-step launch over contiguous f32 ``tensors``
    (every field, halo and window it reads or writes):
    :func:`..plan.stencil_route` of their pointers and byte strides."""
    return stencil_route(torch.float32, X, *(
        v for t in tensors for v in (t.data_ptr(),
                                     *(4 * s for s in t.stride()[:-1]))))


def fused_wave_step_kernel(u: torch.Tensor, u_prev: torch.Tensor,
                           c2dt2: C2, *, plan: HaloPlan, dx: float = 1.0,
                           halos: Optional[Halos] = None,
                           return_halos: bool = False, part: bool = False):
    """One step of every rank of a 1-D symmetric Z ring in one launch of
    ``csrc/fused_wave_step.cu``; on CPU tensors, the plain versions.
    Fields are stacked ``(nz, 1, Z, Y, X)``.

    Without ``halos`` the launch runs the single-step schedule (put,
    interior, fence, boundary).  With ``halos`` (the current field's
    landed ``z_lo``/``z_hi``, each ``(nz, 1, R, Y, X)``) it runs the
    carried schedule (boundary, put, interior, fence) and also writes the
    next field's halos into new tensors.  ``return_halos=True`` returns
    ``(out, Halos(z_lo, z_hi, None, None))`` (``(out, None)`` on the single
    step).  A launch takes the route :func:`..plan.stencil_route` picks,
    counted in ``route_launches``.

    ``part=True`` (carried only): the fields hold a process's consecutive
    ranks of the plan's ring; the launch writes zeros into the halos its
    first and last rank would receive from outside it, which the caller
    fills from the neighbour processes.
    """
    R = RADIUS
    if u.dim() != 5 or u.shape[1] != 1 or u_prev.shape != u.shape:
        raise ValueError(f"fused step takes (nz, 1, Z, Y, X) fields, got "
                         f"{tuple(u.shape)} / {tuple(u_prev.shape)}")
    nz, _, Z, Y, X = u.shape
    if isinstance(c2dt2, torch.Tensor) and c2dt2.shape != u.shape:
        raise ValueError(f"c2 {tuple(c2dt2.shape)} vs field {tuple(u.shape)}")
    carried = halos is not None
    if carried and any(h is None or h.shape != (nz, 1, R, Y, X)
                       for h in (halos.z_lo, halos.z_hi)):
        raise ValueError(f"carried halos must be (nz, 1, R, Y, X) = "
                         f"{(nz, 1, R, Y, X)}")
    ring = nz if not part else plan.nz
    if (plan.nz, plan.ny, plan.halo, plan.z_loc) != (ring, 1, R, Z) \
            or (part and (not carried or ring % nz)):
        raise ValueError(f"plan (nz={plan.nz}, ny={plan.ny}, halo="
                         f"{plan.halo}, z_loc={plan.z_loc}) vs fields of "
                         f"{nz} Z ranks of {Z} rows"
                         + (" (a carried part of the ring)" if part else ""))
    if carried and not (plan.overlap and plan.exchange_axes):
        raise ValueError("carried halos need an overlapping plan over an "
                         "exchanging Z ring")
    if not u.is_cuda:
        if carried:
            out, new = fused_wave_step_carried_plain(u, u_prev, c2dt2, halos,
                                                     dx=dx)
        else:
            out, new = fused_wave_step_plain(u, u_prev, c2dt2, dx=dx), None
        return (out, new) if return_halos else out
    tensors = [u, u_prev] + ([c2dt2] if isinstance(c2dt2, torch.Tensor)
                             else []) \
        + ([halos.z_lo, halos.z_hi] if carried else [])
    if any(t.dtype != torch.float32 or t.device != u.device
           or not t.is_contiguous() for t in tensors):
        raise TypeError("fused step takes contiguous float32 tensors on one "
                        "device")
    if Z < R:
        raise RMAError(f"halo {R} exceeds the local Z extent {Z}")
    out = torch.empty_like(u)
    if carried:
        new = Halos(torch.empty_like(halos.z_lo),
                    torch.empty_like(halos.z_hi), None, None)
        tensors += [out, new.z_lo, new.z_hi]
    else:
        win = torch.empty(nz, 2, R, Y, X, dtype=u.dtype, device=u.device)
        # each rank's count of landed put items, and the item ticket
        sync = torch.zeros(nz + 1, dtype=torch.int32, device=u.device)
        tensors += [out, win]
    route = operand_route(X, tensors)
    bz = default_planner().plan_stencil_bz(Z, Y, X, torch.float32, radius=R,
                                           route=route)
    cptr, c2s = (c2dt2.data_ptr(), 0.0) if isinstance(c2dt2, torch.Tensor) \
        else (None, float(c2dt2))
    lib = library("fused_wave_step")
    code, stream = STENCIL_ROUTES.index(route), stream_handle(u.device)
    if carried:
        status = lib.repro_fused_wave_step_carried(
            u.data_ptr(), u_prev.data_ptr(), cptr, c2s, out.data_ptr(),
            halos.z_lo.data_ptr(), halos.z_hi.data_ptr(),
            new.z_lo.data_ptr(), new.z_hi.data_ptr(), nz, Z, Y, X, bz,
            float(dx * dx), code, stream)
    else:
        new = None
        status = lib.repro_fused_wave_step(
            u.data_ptr(), u_prev.data_ptr(), cptr, c2s, out.data_ptr(),
            win.data_ptr(), sync.data_ptr(), nz, Z, Y, X, int(plan.overlap),
            bz, float(dx * dx), code, stream)
    fused_wave_step_kernel.launches += 1
    fused_wave_step_kernel.route_launches[route] += 1
    check_launch(status, "fused_wave_step")
    return (out, new) if return_halos else out


fused_wave_step_kernel.launches = 0
fused_wave_step_kernel.route_launches = dict.fromkeys(STENCIL_ROUTES, 0)


def _record_single_step(u, zgroup: DiompGroup) -> None:
    """The fused step's exchange audit trail (two slab puts, one fence,
    two reads), exactly as the emulation records it for the single step
    and for the carried one, whose boundary output slabs are R rows of
    the field's shape too; each put rolls the fault plan and retries as
    the emulation's ``ompx_put`` does."""
    R = RADIUS
    lo_w, hi_w = halo_window_names(zgroup, 0)
    ctx = default_context()
    comm = ctx.communicator(zgroup)
    slab = u[..., 0:R, :, :]
    for w in (lo_w, hi_w):
        ctx.rma.ensure(w)
        ctx.rma.on_put(w, payload_bytes(slab, ctx.require_mesh().local_size))
        comm.kernel_put(slab)
    ctx.rma.on_fence(lo_w, hi_w)
    ctx.rma.on_read(lo_w)
    ctx.rma.on_read(hi_w)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def fused_step_route(*, on_card: bool, dtype, dim: int, ny: int,
                     z_extents: Optional[Tuple[int, ...]], plan: HaloPlan,
                     halos: Optional[Halos], return_halos: bool,
                     crosses: bool = False) -> str:
    """Where :func:`fused_wave_step` sends a step: ``"carried"`` or
    ``"single"`` (the fused kernel's two schedules), ``"carried_part"``
    (the carried schedule over a process's box of a ring that crosses
    processes) or ``"emulation"``.

    The kernel takes 1-D (``ny == 1``), symmetric, f32, stacked 5-D steps
    on the card.  Among those, an overlapping plan over an exchanging ring
    with carried halos (given, or asked for with ``return_halos``) runs
    the carried schedule — over the box, its edge halos then fetched from
    the neighbour processes, where the ring ``crosses`` processes; given
    halos on the non-overlapping fallback are the emulation's (it computes
    from them without an exchange); every other step is the single step
    (a one-rank ring ignores halos), whose puts land inside its launch, so
    a ring that crosses processes takes the emulation (its passes are
    wave-step kernel launches on the card) instead.
    """
    if not on_card or ny > 1 or z_extents is not None \
            or dtype != torch.float32 or dim != 5:
        return "emulation"
    overlapped = plan.overlap and bool(plan.exchange_axes)
    if overlapped and (halos is not None or return_halos):
        return "carried_part" if crosses else "carried"
    if (halos is not None and plan.exchange_axes) or crosses:
        return "emulation"
    return "single"


def fused_wave_step(
    u, u_prev, c2dt2: C2, zgroup: DiompGroup,
    ygroup: Optional[DiompGroup] = None, *,
    dx: float = 1.0,
    plan: Optional[HaloPlan] = None,
    halos: Optional[Halos] = None,
    z_extents: Optional[Tuple[int, ...]] = None,
    return_halos: bool = False,
):
    """The fused halo-overlapped wave step entry point on stacked fields.

    ``u``/``u_prev``: ``(nz, ny, Z, Y, X)``.  ``plan`` defaults to the
    process planner's ``plan_halo_slots``.  :func:`fused_step_route`
    decides: on the card a 1-D symmetric f32 step runs the fused kernel,
    single or carried (``halos``/``return_halos`` on an overlapping plan:
    the time loop); 2-D, asymmetric and 16-bit steps (and the CPU) run the
    emulation, whose passes are wave-step kernel launches on the card.
    """
    nz, ny = _sizes(zgroup, ygroup)
    Z, Y, X = u.shape[-3:]
    if z_extents is not None:
        z_extents = tuple(int(e) for e in z_extents)
        if len(z_extents) != nz:
            raise ValueError(
                f"z_extents has {len(z_extents)} entries for {nz} Z ranks")
        if max(z_extents) > Z:
            raise ValueError(
                f"z_extents {z_extents} exceed the padded shard extent {Z}")
    min_z = Z if z_extents is None else min(z_extents)
    if nz > 1 and min_z < RADIUS:
        raise RMAError(
            f"halo {RADIUS} exceeds the smallest local Z extent {min_z}: "
            "the exchange would wrap non-neighbor data into the slab "
            "(merge ranks or grow the grid)")
    if ny > 1 and Y < RADIUS:
        raise RMAError(f"halo {RADIUS} exceeds the local Y extent {Y}")
    if plan is None:
        plan = default_planner().plan_halo_slots(
            Z, Y, X, u.dtype, nz, ny=ny, halo=RADIUS)
    if (plan.nz, plan.ny) != (nz, ny):
        raise ValueError(
            f"plan for (nz={plan.nz}, ny={plan.ny}) used on a "
            f"(nz={nz}, ny={ny}) decomposition")
    if plan.halo != RADIUS:
        raise ValueError(f"plan.halo={plan.halo} != stencil radius {RADIUS}")

    mesh = default_context().require_mesh()
    crosses = crosses_processes(zgroup, mesh) or (
        ygroup is not None and crosses_processes(ygroup, mesh))
    route = fused_step_route(
        on_card=u.is_cuda, dtype=u.dtype, dim=u.dim(), ny=ny,
        z_extents=z_extents, plan=plan, halos=halos,
        return_halos=return_halos, crosses=crosses)
    fused_wave_step.routes[route] += 1
    if route == "emulation":
        return fused_wave_step_emulated(
            u, u_prev, c2dt2, zgroup, ygroup, plan=plan, dx=dx,
            halos=halos, z_extents=z_extents, return_halos=return_halos)
    u, u_prev = u.contiguous(), u_prev.contiguous()
    if route == "single":
        if nz > 1:
            _record_single_step(u, zgroup)
        out = fused_wave_step_kernel(u, u_prev, c2dt2, plan=plan, dx=dx)
        return (out, None) if return_halos else out
    if halos is None:
        # entering the carried loop: prologue exchange of the current field
        halos = exchange_halos(u, zgroup)
    _record_single_step(u, zgroup)      # the carried trail is the same
    part = route == "carried_part"
    out, new = fused_wave_step_kernel(
        u, u_prev, c2dt2, plan=plan, dx=dx, return_halos=True,
        halos=Halos(halos.z_lo.contiguous(), halos.z_hi.contiguous()),
        part=part)
    if part:
        new = _edge_halos(out, new, zgroup, mesh)
    return (out, new) if return_halos else out


fused_wave_step.routes = {"carried": 0, "carried_part": 0, "single": 0,
                          "emulation": 0}


def _edge_halos(out: torch.Tensor, new: Halos, zgroup: DiompGroup,
                mesh) -> Halos:
    """The halos a part launch leaves zero at its box's edges, fetched from
    the neighbour processes' boundary output rows (the kernel's own puts,
    made over the data plane: logged already by the step's recorder).
    Ring ends stay zero."""
    R = RADIUS
    Z = out.shape[-3]
    d = zgroup.rank_dims(mesh)[0]
    last = mesh.local_sizes[d] - 1
    new.z_lo[0] = ring_roll(out[..., Z - R:Z, :, :].contiguous(), zgroup,
                            mesh, 1, edge=0)[0]
    new.z_hi[last] = ring_roll(out[..., 0:R, :, :].contiguous(), zgroup,
                               mesh, -1, edge=mesh.sizes[d] - 1)[last]
    return new
