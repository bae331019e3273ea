"""The paper's user-facing API surface, verbatim names (§3.2–3.3).

DiOMP exposes ``ompx_``-prefixed runtime calls; this module re-exports the
runtime under those names so code written against the paper's listings
ports one-to-one.  Every name is bound to the active
:class:`~repro_torch.core.context.DiompContext`.
"""

from __future__ import annotations

from .groups import DiompGroup as ompx_group_t  # noqa: N813
from .groups import merge as ompx_group_merge
from .groups import world_group as ompx_group_world
from .ompccl import allgather as ompx_allgather
from .ompccl import allreduce as ompx_allreduce
from .ompccl import alltoall as ompx_alltoall
from .ompccl import barrier_value as ompx_barrier
from .ompccl import bcast as ompx_bcast
from .ompccl import reduce as ompx_reduce
from .ompccl import reducescatter as ompx_reducescatter
from .rma import halo_exchange as ompx_halo_exchange
from .rma import ompx_fence, ompx_get, ompx_put  # noqa: F401

__all__ = [
    "ompx_group_t", "ompx_group_merge", "ompx_group_world",
    "ompx_put", "ompx_get", "ompx_fence", "ompx_barrier",
    "ompx_bcast", "ompx_reduce", "ompx_allreduce", "ompx_allgather",
    "ompx_reducescatter", "ompx_alltoall", "ompx_halo_exchange",
]
