"""Pod-aware hierarchical collectives (OMPCCL's topology-aware backend).

For a ("pod", "data", ...) group where "pod" rides the slow inter-pod
links and the remaining axes ride the fast intra-pod ones, a flat
all-reduce pushes the full payload over the slow axis.  The hierarchical
algorithm is the classic three-phase decomposition:

    reduce-scatter (fast axes)  ->  all-reduce (slow axis, 1/F of the data)
                                ->  all-gather (fast axes)

which moves ``2·B·(F-1)/F`` bytes per rank on fast links and
``2·B/F·(S-1)/S`` on slow links, against ``2·B·(P-1)/P`` on every link for
the flat ring (F = fast-domain size, S = slow-domain size, P = F·S): the
inter-pod traffic drops by a factor of F.

Tensors are stacked: the mesh axes are their leading dims
(:mod:`repro_torch.launch.mesh`), and each phase is one mesh axis's
primitive of :mod:`repro_torch.core.backends` over them, in the
reference's order, so shards land where the reference's land.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.backends import (XlaBackend, _local_dim, all_gather_axis,
                             check_stacked, psum_axis, psum_scatter_axis)
from ..core.groups import DiompGroup
from ..launch.mesh import RankMesh

__all__ = [
    "hierarchical_allreduce",
    "hierarchical_allgather",
    "flat_allreduce",
    "inter_pod_traffic_bytes",
]


def flat_allreduce(x: torch.Tensor, group: DiompGroup, mesh: RankMesh, *,
                   op: str = "sum") -> torch.Tensor:
    """The single-phase reduction over every group axis at once."""
    if op not in ("sum", "max", "min"):
        raise ValueError(op)
    return XlaBackend().allreduce(x, group, mesh, op=op)


def hierarchical_allreduce(x: torch.Tensor, group: DiompGroup,
                           mesh: RankMesh, *, op: str = "sum"
                           ) -> torch.Tensor:
    """RS(fast) -> AR(slow) -> AG(fast).  First group axis is the slow one.

    Exact for ``op="sum"``; other ops take the flat algorithm (they do not
    decompose through a scatter).  A payload that the fast domain does not
    divide is zero-padded on the way in and cut on the way out.
    """
    if len(group.axes) < 2 or op != "sum":
        return flat_allreduce(x, group, mesh, op=op)
    check_stacked(x, group, mesh)
    slow, fast = group.axes[0], group.axes[1:]
    fast_size = math.prod(mesh.shape[ax] for ax in fast)
    lead, local = x.shape[:mesh.ndim], x.shape[mesh.ndim:]
    flat = x.reshape(*lead, -1)
    n = flat.shape[-1]
    pad = (-n) % fast_size
    if pad:
        flat = F.pad(flat, (0, pad))
    dim = mesh.ndim                  # the flat payload's dim
    # phase 1: reduce-scatter across the fast axes, in group order
    shard = flat
    for ax in fast:
        shard = psum_scatter_axis(shard, mesh, ax, dim)
    # phase 2: all-reduce across the slow axis on 1/fast_size of the bytes
    shard = psum_axis(shard, mesh, slow)
    # phase 3: all-gather across the fast axes, innermost first
    out = shard
    for ax in reversed(fast):
        out = all_gather_axis(out, mesh, ax, dim)
    if pad:
        out = out[..., :n]
    return out.reshape(*lead, *local).contiguous()


def hierarchical_allgather(x: torch.Tensor, group: DiompGroup,
                           mesh: RankMesh, *, axis: int = 0) -> torch.Tensor:
    """Gather along the fast axes first (cheap), the slow axis last; the
    concatenation order is the group's row-major rank order."""
    check_stacked(x, group, mesh)
    dim = _local_dim(x, mesh, axis)
    out = x
    for ax in (*reversed(group.axes[1:]), group.axes[0]):
        out = all_gather_axis(out, mesh, ax, dim)
    return out.contiguous()


def inter_pod_traffic_bytes(payload_bytes: int, fast_size: int,
                            slow_size: int, *,
                            hierarchical: bool = True) -> float:
    """Analytic inter-pod bytes a rank sends: the napkin-math helper."""
    if slow_size <= 1:
        return 0.0
    if hierarchical:
        b = payload_bytes / fast_size
        return 2 * b * (slow_size - 1) / slow_size
    p = fast_size * slow_size
    return 2 * payload_bytes * (p - 1) / p
