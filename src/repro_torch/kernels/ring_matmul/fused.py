"""Fused ring collective matmul: one schedule, two executions.

Both execute :meth:`repro_torch.kernels.plan.RingPlan.schedule` over
stacked ranks (``x (n, t_loc, K)``, ``w (n, K, n_loc)`` ->
``(n, n·t_loc, n_loc)``):

* :func:`fused_ring_allgather_matmul_kernel` — the CUDA kernel
  (``csrc/ring_matmul.cu``, which replaces
  ``fused_ring_allgather_matmul_tpu``): every rank's ring in one
  cooperative launch, puts as stores into a device-memory slot buffer,
  the fence a grid barrier, the GEMM tiles on the route
  :func:`..plan.gemm_route` picks (counted per route in
  ``route_launches``);
* :func:`fused_ring_allgather_matmul_emulated` — each put an ``ompx_put``
  (a roll along the ring's rank dim) started before the step's GEMMs, for
  any mesh, any ``dot``, and the CPU.

:func:`fused_ring_route` picks between them.  A ring that crosses the
processes of a job cannot run in one launch — the kernel's slots and grid
barrier live in one process, and two processes' kernels on one card are
time-sliced, not concurrent, so a spin on a peer process's flag could stall
for a whole timeslice — so it runs the plan's schedule step by step: every
GEMM one launch of the matmul kernel on the card, every cross-process put
through the data plane of :mod:`repro_torch.core.coordination`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...core.backends import crosses_processes
from ...core.context import default_communicator, default_context
from ...core.groups import DiompGroup
from ...core.rma import ompx_put
from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import RingPlan, default_planner, gemm_route
from .kernel import matmul_kernel
from .ref import ring_allgather_matmul_plain

__all__ = [
    "fused_ring_route",
    "fused_ring_allgather_matmul",
    "fused_ring_allgather_matmul_emulated",
    "fused_ring_allgather_matmul_kernel",
]


def _ring_slots(plan: RingPlan) -> int:
    """The slot count the kernel allocates: the plan's grant, floored at the
    reference's reuse-safe count (three per direction on the bidirectional
    ring, one per step on a unidirectional one).  The grid barrier after
    every step would make two enough here."""
    steps = plan.exchange_steps
    need = min(steps + 1, 3) if plan.direction == "bidi" else steps + 1
    return max(plan.slots, need)


def _schedule_table(plan: RingPlan, device) -> torch.Tensor:
    """RingPlan.schedule() as the kernel's int32 table (one row per step:
    index, compute_cw, compute_ccw, send_cw, send_ccw)."""
    rows = [[st.index, st.compute_cw, st.compute_ccw, st.send_cw, st.send_ccw]
            for st in plan.schedule()]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def fused_ring_allgather_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                                       plan: RingPlan) -> torch.Tensor:
    """The whole ring of every rank in one launch of ``csrc/ring_matmul.cu``;
    on a CPU tensor, the plain all-gather matmul."""
    if not x.is_cuda:
        return ring_allgather_matmul_plain(x, w)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"ring shapes {tuple(x.shape)} x {tuple(w.shape)}: "
                         "need (n, t_loc, K) and (n, K, n_loc)")
    if x.device != w.device or x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"ring operands {x.dtype}@{x.device}, "
                        f"{w.dtype}@{w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("ring kernel takes contiguous operands")
    n, t_loc, k = x.shape
    n_loc = w.shape[2]
    if plan.n != n:
        raise ValueError(f"plan for n={plan.n} used on a ring of {n}")
    slots = _ring_slots(plan)
    bufs = torch.empty(n, 2, slots, t_loc, k, dtype=x.dtype, device=x.device)
    sched = _schedule_table(plan, x.device)
    out = torch.empty(n, n * t_loc, n_loc, dtype=x.dtype, device=x.device)
    route = gemm_route(x.dtype, k, n_loc, x.data_ptr(), w.data_ptr(),
                       bufs.data_ptr())
    status = library("ring_matmul").repro_ring_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), bufs.data_ptr(),
        sched.data_ptr(), sched.shape[0], n, slots, t_loc, k, n_loc,
        DTYPE_CODES[x.dtype], ROUTE_CODES[route], stream_handle(x.device))
    fused_ring_allgather_matmul_kernel.launches += 1
    fused_ring_allgather_matmul_kernel.route_launches[route] += 1
    check_launch(status, "fused_ring_allgather_matmul")
    return out


fused_ring_allgather_matmul_kernel.launches = 0
fused_ring_allgather_matmul_kernel.route_launches = dict.fromkeys(ROUTE_CODES,
                                                                  0)


def fused_ring_allgather_matmul_emulated(
    x: torch.Tensor, w: torch.Tensor, group: DiompGroup, *, plan: RingPlan,
    dot: Optional[Callable] = None,
) -> torch.Tensor:
    """Execute :meth:`RingPlan.schedule` with ``ompx_put`` as the remote copy.

    Every step starts its forwards BEFORE its GEMMs, the kernel's order.
    ``x``/``w`` are stacked over the context's mesh; the ring is
    ``group``'s rank dim.
    """
    from .ops import box_lead

    dot = dot or matmul_kernel
    mesh = default_context().require_mesh()
    d = group.rank_dims(mesh)[0]
    n, t_loc = plan.n, x.shape[-2]
    out = torch.zeros(*x.shape[:-2], n * t_loc, w.shape[-1], dtype=x.dtype,
                      device=x.device)
    # (..., src, t_loc, n_loc) view: the ring writes whole source blocks
    blocks = out.unflatten(-2, (n, t_loc))
    lead, coord = box_lead(mesh, x.device)
    rank = coord[d]

    cw = ccw = x
    for st in plan.schedule():
        cw_next = ompx_put(cw, group, shift=1) if st.send_cw else cw
        ccw_next = ompx_put(ccw, group, shift=-1) if st.send_ccw else ccw
        if st.compute_cw:
            blocks[(*lead, (rank - st.index) % n)] = dot(cw, w).to(out.dtype)
        if st.compute_ccw:
            blocks[(*lead, (rank + st.index) % n)] = dot(ccw, w).to(out.dtype)
        cw, ccw = cw_next, ccw_next
    return out


def _record_traffic(x, group: DiompGroup, plan: RingPlan) -> None:
    """Log the schedule's puts as the emulation's ``ompx_put`` logs them:
    the call and byte logs, the fault plan's rolls and retries."""
    comm = default_communicator(group)
    for st in plan.schedule():
        for sent in (st.send_cw, st.send_ccw):
            if sent:
                comm.kernel_put(x)


def fused_ring_route(*, on_card: bool, custom_dot: bool, mesh_ndim: int,
                     crosses: bool) -> str:
    """Where :func:`fused_ring_allgather_matmul` sends a ring: ``"kernel"``
    (row 2, every rank's ring in one launch: on the card, a mesh that is
    the ring alone, no custom ``dot``, every rank in this process),
    ``"stepwise"`` (the same on a ring that ``crosses`` processes: the
    schedule step by step, each GEMM a launch of row 1, the puts over the
    data plane) or ``"emulation"`` (the CPU, other meshes, a custom
    ``dot``)."""
    if not on_card or custom_dot or mesh_ndim != 1:
        return "emulation"
    return "stepwise" if crosses else "kernel"


def fused_ring_allgather_matmul(
    x: torch.Tensor, w: torch.Tensor, group: DiompGroup, *,
    plan: Optional[RingPlan] = None,
    direction: str = "bidi",
    dot: Optional[Callable] = None,
) -> torch.Tensor:
    """The fused collective matmul entry point on stacked ranks.

    ``plan`` defaults to the process planner's
    :meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_ring_matmul`.  On
    the card, a mesh that is the ring alone and no custom ``dot`` run the
    CUDA kernel — its puts are logged on the communicator before the
    launch (:meth:`~repro_torch.core.context.Communicator.kernel_put`:
    recorded, and rolled under the fault plan and retried, as the
    emulation's ``ompx_put`` is); a ring that crosses processes runs step
    by step, and everything else runs the emulation
    (:func:`fused_ring_route`, counted in ``.routes``).
    """
    mesh = default_context().require_mesh()
    n = group.axis_size(mesh)
    if plan is None:
        plan = default_planner().plan_ring_matmul(
            x.shape[-2], x.shape[-1], w.shape[-1], x.dtype, n,
            direction=direction)
    if plan.n != n:
        raise ValueError(f"plan for n={plan.n} used on a ring of {n}")
    route = fused_ring_route(on_card=x.is_cuda, custom_dot=dot is not None,
                             mesh_ndim=mesh.ndim,
                             crosses=crosses_processes(group, mesh))
    fused_ring_allgather_matmul.routes[route] += 1
    if route == "kernel":
        _record_traffic(x, group, plan)
        return fused_ring_allgather_matmul_kernel(x, w, plan=plan)
    return fused_ring_allgather_matmul_emulated(x, w, group, plan=plan,
                                                dot=dot)


fused_ring_allgather_matmul.routes = {"kernel": 0, "stepwise": 0,
                                      "emulation": 0}
