"""Ring collective matmul — Cannon's algorithm adapted to the TP ring.

The paper's matrix-multiplication application (§4.4) pipelines Cannon's ring
exchange so each rank's ``ompx_put`` of the next block stripe overlaps the
current block's GEMM; on a ring group the same schedule computes the
all-gather matmul ``Y = X_full @ W_col`` without materializing X_full.
Operands are stacked over the context's mesh: ``x (..., t_loc, K)``,
``w (..., K, n_loc)`` -> ``(..., n·t_loc, n_loc)``.

* ``overlap=False``   — all-gather X + one big GEMM (the MPI+X baseline);
* ``impl="host"``     — the unrolled host ring: one GEMM + put per step;
* ``impl="fused"``    — the planned bidirectional ring (:mod:`.fused`): one
                        CUDA kernel on the card, the step-for-step
                        emulation elsewhere (default).

``matmul`` is the local GEMM: ``impl="cuda"`` is the hand-written kernel
(the counterpart of the reference's ``impl="pallas"``), ``"ref"`` the plain
version.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...core.context import default_context
from ...core.groups import DiompGroup
from ...core.rma import ompx_put
from ..plan import RingPlan, resolve_ring_impl
from .fused import fused_ring_allgather_matmul
from .kernel import matmul_kernel
from .ref import matmul_ref, ring_allgather_matmul_ref

__all__ = ["matmul", "ring_allgather_matmul"]


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           impl: str = "ref") -> torch.Tensor:
    if impl == "ref":
        return matmul_ref(x, w)
    if impl == "cuda":
        return matmul_kernel(x, w)
    raise ValueError(impl)


def _host_ring(x, w, group: DiompGroup, dot: Callable):
    """The host-level unrolled ring (one put + GEMM per step, n-1 puts)."""
    mesh = default_context().require_mesh()
    d = group.rank_dims(mesh)[0]
    n, t_loc = group.axis_size(mesh), x.shape[-2]
    out = torch.zeros(*x.shape[:-2], n * t_loc, w.shape[-1], dtype=x.dtype,
                      device=x.device)
    blocks = out.unflatten(-2, (n, t_loc))
    lead = torch.meshgrid(*[torch.arange(s, device=x.device)
                            for s in mesh.sizes], indexing="ij")
    chunk = x
    for s in range(n):
        src = (lead[d] - s) % n           # whose stripe each rank holds
        blocks[(*lead, src)] = dot(chunk, w).to(out.dtype)
        if s != n - 1:
            chunk = ompx_put(chunk, group, shift=1)
    return out


def ring_allgather_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    group: DiompGroup,
    *,
    overlap: bool = True,
    impl: Optional[str] = None,
    dot: Optional[Callable] = None,
    plan: Optional[RingPlan] = None,
) -> torch.Tensor:
    """Stacked ``x (..., t_loc, K)``, ``w (..., K, n_loc)`` -> ``(..., T, n_loc)``.

    ``overlap=False`` falls back to all-gather + one GEMM; otherwise
    ``impl`` picks ``"fused"`` (default) or ``"host"``.
    """
    if not overlap:
        return ring_allgather_matmul_ref(x, w, group)
    if resolve_ring_impl(impl) == "fused":
        # dot is forwarded un-defaulted: a caller-supplied dot forces the
        # emulation (the fused kernel cannot honor custom GEMM semantics)
        return fused_ring_allgather_matmul(x, w, group, plan=plan, dot=dot)
    return _host_ring(x, w, group, dot or matmul_kernel)
