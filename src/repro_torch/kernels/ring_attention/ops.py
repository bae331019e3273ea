"""Public wrapper for sequence-parallel ring attention on stacked ranks.

``q (*mesh, B, tq, H, D)``, ``k/v (*mesh, B, tk, KH, D/Dv)`` per-rank
shards -> ``(*mesh, B, tq, H, Dv)``, the ring being ``group``'s rank dim.
``plan=None`` asks the process planner for the slots and key tile;
``impl`` resolves ``"auto"``/None to the ``"fused"`` overlap order
(``"host"`` is the serialized listing).  Both run the CUDA kernel on the
card and its plain version (the ``ompx_put`` emulation) on the CPU.

``q_offset`` and ``valid_len`` may be int tensors (chunked prefill): the
plan then skips nothing statically and the masks, or on the card the
kernel's per-tile key bounds, handle everything.  The reference's TPU
kernel bakes static offsets and refuses tensors; the port's kernel reads
them from the device, which is the function its emulation computes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...core.context import default_context
from ...core.groups import DiompGroup
from ..plan import AttentionRingPlan, default_planner
from .fused import fused_ring_attention_kernel

__all__ = ["ring_attention", "resolve_attention_impl"]


def resolve_attention_impl(impl: Optional[str]) -> str:
    """``"auto"``/None pick the fused overlap order; explicit ``"host"``
    (serialized put-fence-compute listing) and ``"fused"`` pass through —
    the ring matmul's convention."""
    if impl in (None, "auto"):
        return "fused"
    if impl in ("host", "fused"):
        return impl
    raise ValueError(f"unknown ring attention impl {impl!r}")


def _static(val) -> Optional[int]:
    return None if isinstance(val, torch.Tensor) else val


def ring_attention(q, k, v, group: DiompGroup, *, causal: bool = True,
                   q_offset=0, valid_len=None, scale: Optional[float] = None,
                   q_sharded: bool = True,
                   plan: Optional[AttentionRingPlan] = None,
                   impl: Optional[str] = None):
    """The fused ring attention entry point (see the module doc)."""
    if len(group.axes) != 1:
        raise ValueError(
            f"ring attention needs a single-axis group, got {group.axes}")
    mesh = default_context().require_mesh()
    n = group.axis_size(mesh)
    B, tq, H, D = q.shape[mesh.ndim:]
    tk, KH = k.shape[-3], k.shape[-2]
    Dv = v.shape[-1]
    if H % KH:
        raise ValueError(f"H={H} not divisible by kv heads {KH}")
    mode = resolve_attention_impl(impl)
    if plan is None:
        plan = default_planner().plan_ring_attention(
            B, tq, tk, H, KH, D, Dv, q.dtype, n, causal=causal,
            q_sharded=q_sharded, q_offset=_static(q_offset),
            valid_len=_static(valid_len), overlap=mode == "fused")
    if plan.n != n:
        raise ValueError(f"plan for n={plan.n} used on a ring of {n}")
    if plan.overlap != (mode == "fused"):
        plan = dataclasses.replace(plan, overlap=mode == "fused")
    return fused_ring_attention_kernel(q, k, v, group, plan=plan, scale=scale,
                                       q_offset=q_offset, valid_len=valid_len)
