"""MoE dispatch entry point — the op ``moe_block`` routes through.

``moe_dispatch`` is the dropless one-sided counterpart of the host
``ompccl.alltoall`` capacity path, on stacked ranks: the exchange is the
:class:`~repro_torch.kernels.plan.AllToAllPlan` ring of one-sided puts
with the return combine after each block's expert GEMMs.

* ``impl="fused"`` — the overlapped schedule;
* ``impl="host"``  — the same one-sided traffic serialized (all dispatch
  puts, the fences, the GEMMs, all combine puts, one fence).

Both run the CUDA kernel on the card and its plain version on the CPU; a
custom ``mlp`` runs the emulation (on either device) with that MLP.  The
routing stats (``moe_dropped`` / ``moe_routed``) are recorded into the
active :class:`~repro_torch.core.context.DispatchStats` frame; on a plan
sized from measured load the dropped count is zero.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ...core.context import default_context
from ...core.groups import DiompGroup
from ..plan import AllToAllPlan, default_planner, resolve_dispatch_impl
from .fused import fused_moe_dispatch_interpret, fused_moe_dispatch_kernel

__all__ = ["moe_dispatch"]


def moe_dispatch(toks, top_e, top_w, wg, wu, wd, group: DiompGroup, *,
                 impl: Optional[str] = None,
                 plan: Optional[AllToAllPlan] = None,
                 mlp: Optional[Callable] = None):
    """Dropless expert-parallel dispatch + MLP + combine on stacked ranks.

    ``toks (*mesh, t_loc, d)`` — every rank's token rows; ``top_e/top_w
    (*mesh, t_loc, k)`` — their routing; ``wg/wu (*mesh, E_loc, d, f)``,
    ``wd (*mesh, E_loc, f, d)`` — each rank's own experts.  Returns the
    gate-combined ``(*mesh, t_loc, d)``.

    ``plan`` defaults to the process planner's worst-case dropless plan
    (``caps[e] = t_loc``: nothing is measured inside a step); callers that
    measured routing pass a load-sized plan.  The EP group must be a
    single mesh axis (the put ring); ``plan.overlap`` is set by ``impl``.
    """
    impl = resolve_dispatch_impl(impl)
    if impl == "a2a":
        raise ValueError(
            "impl='a2a' is the host collective path inside moe_block; "
            "moe_dispatch implements the one-sided 'host'/'fused' modes")
    if len(group.axes) != 1:
        raise ValueError(
            f"moe_dispatch needs a single-axis EP group, got {group.axes}")
    ctx = default_context()
    ep = group.axis_size(ctx.require_mesh())
    t_loc, d = toks.shape[-2:]
    k = top_e.shape[-1]
    E = wg.shape[-3] * ep
    if plan is None:
        plan = default_planner().plan_alltoall(
            t_loc, d, k, E, ep, toks.dtype, overlap=(impl == "fused"))
    if plan.ep != ep:
        raise ValueError(f"plan for ep={plan.ep} used on a ring of {ep}")
    if plan.E != E:
        raise ValueError(f"plan for E={plan.E} used with E={E}")
    if plan.overlap != (impl == "fused"):
        plan = dataclasses.replace(plan, overlap=(impl == "fused"))

    if mlp is not None:
        combined, dropped = fused_moe_dispatch_interpret(
            toks, top_e, top_w, wg, wu, wd, group, plan=plan, mlp=mlp)
    else:
        combined, dropped = fused_moe_dispatch_kernel(
            toks, top_e, top_w, wg, wu, wd, group, plan=plan)
    ctx.dispatch_stats.record(
        moe_dropped=dropped, moe_routed=torch.full_like(dropped, t_loc * k))
    return combined
