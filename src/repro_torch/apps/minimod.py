"""Minimod — the paper's flagship application as a driver (§4.5).

* **2-D (Z×Y) domain decomposition** with **asymmetric** Z extents —
  heterogeneous ranks own subdomains proportional to their ``weights``; the
  wavefield regions are registered through
  :meth:`~repro_torch.core.pgas.GlobalMemory.alloc_asymmetric`.
* **Three execution modes**:

  - ``none``  — two-sided MPI-shaped exchange (paper Listing 2: gather the
    slabs, select, barrier), compute strictly after;
  - ``host``  — one-sided puts + one fence (paper Listing 1), full-grid
    compute after the fence;
  - ``fused`` — the halo-overlapped step of
    :mod:`repro_torch.kernels.stencil.fused` with carried halos.

* **Audit trail**: every one-sided put is recorded both on the OMPCCL
  communicator byte log and on the RMATracker's halo windows.

Fields are stacked ``(nz, ny, zmax, Y/ny, X)`` on the run's device (the card
unless ``device="cpu"``).  There a 1-D symmetric f32 fused run launches
the fused wave-step kernel's carried schedule once a step; every pass of
the other modes and decompositions is a wave-step kernel launch.

Logs are per call site, as in the reference, which records its time loop's
body once (it is traced once under ``lax.scan``): the first pass through
the port's Python loop records against the run's context, later passes
against a scratch context whose logs are dropped.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core import ompccl, rma
from ..core.context import DiompContext, use_default
from ..core.faults import FaultPlan
from ..core.groups import DiompGroup
from ..core.resilience import RetryPolicy
from ..kernels.plan import HaloPlan, default_planner, split_extents
from ..kernels.stencil.fused import (Halos, _zslice, exchange_halos,
                                     fused_wave_step)
from ..kernels.stencil.kernel import leap
from ..kernels.stencil.ref import RADIUS
from ..launch.mesh import RankMesh
from ..launch.shapes import STENCIL_SHAPES, StencilShape

__all__ = [
    "MODES",
    "MinimodResult",
    "halo_loc",
    "pad_shards",
    "run_minimod",
    "split_extents",
    "unpad_shards",
]

MODES = ("none", "host", "fused")


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------


def pad_shards(a: torch.Tensor, z_extents: Sequence[int]) -> torch.Tensor:
    """(Z, Y, X) logical grid -> (nz·zmax, Y, X) padded layout."""
    zmax = max(z_extents)
    if len(set(z_extents)) == 1:
        return a
    blocks, off = [], 0
    for e in z_extents:
        blocks.append(F.pad(a[off:off + e], (0, 0, 0, 0, 0, zmax - e)))
        off += e
    return torch.cat(blocks, dim=0)


def unpad_shards(a: torch.Tensor, z_extents: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`pad_shards`: drop every rank's padding rows."""
    zmax = max(z_extents)
    if len(set(z_extents)) == 1:
        return a
    return torch.cat(
        [a[i * zmax:i * zmax + e] for i, e in enumerate(z_extents)], dim=0)


def _to_ranks(a: torch.Tensor, nz: int, ny: int) -> torch.Tensor:
    """(nz·zmax, Y, X) -> stacked (nz, ny, zmax, Y/ny, X)."""
    Zp, Y, X = a.shape
    return a.reshape(nz, Zp // nz, ny, Y // ny, X).permute(
        0, 2, 1, 3, 4).contiguous()


def _from_ranks(s: torch.Tensor) -> torch.Tensor:
    """Stacked (nz, ny, zmax, y_loc, X) -> (nz·zmax, ny·y_loc, X)."""
    nz, ny, zmax, y_loc, X = s.shape
    return s.permute(0, 2, 1, 3, 4).reshape(nz * zmax, ny * y_loc, X)


# ---------------------------------------------------------------------------
# the two baseline halo styles (the paper's programmability comparison)
# ---------------------------------------------------------------------------


def _host_step_listing1(u, u_prev, c2dt2, zgroup, *, dx=1.0):
    """Minimod step, DiOMP style (paper Listing 1): two one-sided puts +
    one fence, then the full-grid stencil."""
    R = RADIUS
    left, right = rma.halo_exchange(u, zgroup, halo=R, axis=0)
    uext = F.pad(u, (R, R, R, R, R, R))
    uext[..., 0:R, R:-R, R:-R] = left
    uext[..., -R:, R:-R, R:-R] = right
    return leap(uext, u_prev, c2dt2, dx=dx)


def _two_sided_halos(u, zgroup, *, ext):
    """MPI style (paper Listing 2): explicit sends, receives and Waitall —
    every slab materialized on every rank, then selected and barriered."""
    R = RADIUS
    n = len(ext)
    down = _zslice(u, [e - R for e in ext], R)
    up_slab = u[..., 0:R, :, :]
    all_down = ompccl.allgather(down, zgroup, axis=0).unflatten(-3, (n, R))
    all_up = ompccl.allgather(up_slab, zgroup, axis=0).unflatten(-3, (n, R))
    iz = torch.arange(n, device=u.device)
    left = all_down[iz, :, (iz + n - 1) % n]
    right = all_up[iz, :, (iz + 1) % n]
    left[0] = 0
    right[n - 1] = 0
    ompccl.barrier_value(zgroup)        # MPI_Waitall
    return Halos(left, right, None, None)


def halo_loc() -> Dict[str, int]:
    """Lines of code of the two halo styles (the paper's Fig. 8 claim:
    the one-sided listing is the shorter)."""
    one = len(inspect.getsource(_host_step_listing1).strip().splitlines())
    two = len(inspect.getsource(_two_sided_halos).strip().splitlines())
    return {"diomp": one, "two_sided": two}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MinimodResult:
    """One Minimod run plus its audit trail."""

    field: torch.Tensor                # (Z, Y, X) logical wavefield
    wall_s: float                      # the time loop (CUDA events on the card)
    mode: str
    grid: Tuple[int, int, int]
    steps: int
    nz: int
    ny: int
    z_extents: Tuple[int, ...]
    plan: HaloPlan
    # OMPCCL communicator log (one entry per call site)
    puts: int
    put_bytes: int
    # RMATracker halo-window accounting
    tracker_puts: int
    tracker_put_bytes: int
    fences: int
    window_bytes: Dict[str, int]
    # PGAS plan of the wavefield regions
    region_sizes: Tuple[int, ...]
    alloc_counts: Dict[str, int]
    # re-issued wire attempts under a fault plan (the retry logs)
    retries: int = 0
    retry_bytes: int = 0

    @property
    def energy(self) -> float:
        return float(self.field.double().square().sum())


def _initial(a, grid, dtype, device, default_point: bool) -> torch.Tensor:
    if a is None:
        a = torch.zeros(grid, dtype=dtype, device=device)
        if default_point:
            a[grid[0] // 2, grid[1] // 2, grid[2] // 2] = 1.0  # point source
        return a
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a).to(device=device, dtype=dtype)


def run_minimod(
    grid: Tuple[int, int, int] = (64, 64, 64),
    steps: Optional[int] = None,
    nz: int = 8,
    ny: int = 1,
    weights: Optional[Sequence[float]] = None,
    *,
    mode: str = "fused",
    dtype: torch.dtype = torch.float32,
    c2dt2: float = 0.1,
    dx: float = 1.0,
    shape: Union[None, str, StencilShape] = None,
    u0=None,
    u_prev0=None,
    device="cuda",
    fault_plan: Optional[FaultPlan] = None,
    retry_policy: Optional[RetryPolicy] = None,
) -> MinimodResult:
    """Run ``steps`` of Minimod on an (nz × ny) decomposition.

    ``shape`` (a :data:`~repro_torch.launch.shapes.STENCIL_SHAPES` cell or
    name) overrides grid/steps/nz/ny/weights.  The default initial
    condition is the point source at the grid center; ``u0``/``u_prev0``
    are logical (Z, Y, X) arrays or tensors.  Runs on the card unless
    ``device="cpu"``.  ``fault_plan`` and ``retry_policy`` go to the run's
    context (the ``DiompContext`` defaults otherwise); as the reference
    traces its time loop once, only the first step's verbs roll the plan.
    """
    if isinstance(shape, str):
        shape = STENCIL_SHAPES[shape]
    if shape is not None:
        grid = shape.grid
        steps = shape.steps if steps is None else steps
        nz, ny = shape.nz, shape.ny
        weights = shape.weights if weights is None else weights
    steps = 10 if steps is None else steps
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    Z, Y, X = grid
    if Y % ny:
        raise ValueError(f"Y={Y} not divisible by ny={ny} (Y is symmetric)")
    if mode == "none" and ny > 1:
        raise ValueError("the two-sided baseline is 1-D only (use ny=1)")
    z_extents = split_extents(Z, nz, weights, minimum=RADIUS)
    symmetric = len(set(z_extents)) == 1
    zmax = max(z_extents)
    y_loc = Y // ny

    mesh = RankMesh(("z", "y"), (nz, ny))
    ctx = DiompContext(mesh=mesh, device=device, fault_plan=fault_plan,
                       retry_policy=retry_policy)
    replay = DiompContext(mesh=mesh, device=device, fault_plan=FaultPlan(0))
    dev = ctx.device
    with use_default(ctx):
        zg = DiompGroup(("z",), name="z")
        yg = DiompGroup(("y",), name="y") if ny > 1 else None
        grid_group = DiompGroup(("z", "y"), name="grid")

        # PGAS registration: rank (iz, iy) holds z_extents[iz]·y_loc·X cells,
        # addressed through the second-level pointer
        item = torch.empty((), dtype=dtype).element_size()
        sizes = [z_extents[r // ny] * y_loc * X * item
                 for r in range(nz * ny)]
        handles = [
            ctx.memory.alloc_asymmetric(f"minimod.{nm}", sizes, grid_group,
                                        logical_axes=("z", "y", None),
                                        dtype=str(dtype).replace("torch.", ""))
            for nm in ("u", "u_prev")
        ]
        region_sizes = tuple(handles[0].region.sizes)

        plan = default_planner().plan_halo_slots(
            zmax, y_loc, X, dtype, nz, ny=ny, halo=RADIUS)
        ext_arg = None if symmetric else tuple(z_extents)
        u = _to_ranks(pad_shards(_initial(u0, grid, dtype, dev, True),
                                 z_extents), nz, ny)
        up = _to_ranks(pad_shards(_initial(u_prev0, grid, dtype, dev, False),
                                  z_extents), nz, ny)
        serial_plan = dataclasses.replace(plan, overlap=False)

        if mode == "fused":
            def step(u, up, h):
                if plan.overlap:
                    return fused_wave_step(
                        u, up, c2dt2, zg, yg, dx=dx, plan=plan, halos=h,
                        z_extents=ext_arg, return_halos=True)
                return fused_wave_step(u, up, c2dt2, zg, yg, dx=dx, plan=plan,
                                       z_extents=ext_arg), None
        elif mode == "host":
            def step(u, up, h):
                if symmetric and ny == 1:     # the paper-verbatim listing
                    return _host_step_listing1(u, up, c2dt2, zg, dx=dx), None
                return fused_wave_step(u, up, c2dt2, zg, yg, dx=dx,
                                       plan=serial_plan,
                                       z_extents=ext_arg), None
        else:
            def step(u, up, h):
                halos = _two_sided_halos(u, zg, ext=z_extents)
                return fused_wave_step(u, up, c2dt2, zg, yg, dx=dx,
                                       plan=serial_plan, halos=halos,
                                       z_extents=ext_arg), None

        # the loop's time: CUDA events on the card (the set-up queued before
        # the start event is not counted), the host clock on the CPU
        on_card = dev.type == "cuda"
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        halos = exchange_halos(u, zg, yg, z_extents=ext_arg) \
            if mode == "fused" and plan.overlap else None
        for s in range(steps):
            with use_default(ctx if s == 0 else replay):
                un, halos = step(u, up, halos)
            u, up = un, u
        if on_card:
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 1e3
        else:
            wall = time.perf_counter() - t0

        for h in handles:
            ctx.memory.free(h)
        stats = ctx.stats()
        bstats = ctx.byte_stats()
        retries = ctx.retry_stats()
        rbytes = ctx.retry_byte_stats()
        return MinimodResult(
            field=unpad_shards(_from_ranks(u), z_extents),
            wall_s=wall, mode=mode, grid=tuple(grid), steps=steps, nz=nz,
            ny=ny, z_extents=z_extents,
            plan=plan if mode == "fused" else serial_plan,
            puts=sum(ops.get("put", 0) for ops in stats.values()),
            put_bytes=sum(ops.get("put", 0) for ops in bstats.values()),
            tracker_puts=ctx.rma.puts,
            tracker_put_bytes=ctx.rma.put_bytes,
            fences=ctx.rma.fences,
            window_bytes=dict(ctx.rma.window_bytes),
            region_sizes=region_sizes,
            alloc_counts=dict(ctx.memory.alloc_counts),
            retries=sum(sum(ops.values()) for ops in retries.values()),
            retry_bytes=sum(sum(ops.values()) for ops in rbytes.values()),
        )
