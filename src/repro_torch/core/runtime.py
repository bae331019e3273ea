"""DiompRuntime — the unified runtime of paper Fig. 1(b).

A registration layer over one :class:`~repro_torch.core.context.DiompContext`,
which owns what MPI+libomptarget keep in separate, duplicated tables:

* the **mesh** (the ranks the PGAS space spans),
* the **GlobalMemory** arena plan (symmetric/asymmetric regions),
* the **groups** (communicators) and their OMPCCL communicator table,
* the **StreamPool** (bounded async host work),
* the **sharding rules** that translate logical placement to mesh axes.

Every tensor the framework materializes is *registered* here first: one
table row records its arena offsets, its spec and its group, so the
compute, RMA and collective layers read one source of truth.  Registration
returns the :class:`~repro_torch.distributed.sharding.RankSharding` that
:meth:`DiompRuntime.place` lays a host value out by, on the context's
device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..distributed import sharding as shrd
from ..interop import stack_shards
from ..launch.mesh import RankMesh
from .context import DiompContext, install_default as _install_default
from .groups import DiompGroup
from .pgas import SecondLevelPtr

__all__ = ["DiompRuntime", "RegisteredTensor", "dtype_bytes"]

_DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1,
    "int32": 4, "int64": 8, "bool": 1, "float64": 8, "uint32": 4,
}


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype`` (a name or a ``torch.dtype``)."""
    return _DTYPE_BYTES[str(dtype).replace("torch.", "")]


@dataclasses.dataclass(frozen=True)
class RegisteredTensor:
    """One row of the unified mapping table."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    logical_axes: Tuple[Optional[str], ...]
    spec: tuple
    region: Any  # Region | SecondLevelPtr
    group: DiompGroup

    @property
    def symmetric(self) -> bool:
        r = self.region.region if isinstance(self.region, SecondLevelPtr) \
            else self.region
        return r.symmetric


class DiompRuntime:
    """One process driving every rank of the mesh — the deployment the
    paper argues for: host threads stay unified (the StreamPool drives
    async work) while collectives run through OMPCCL groups."""

    def __init__(
        self,
        mesh: RankMesh,
        *,
        device="cuda",
        segment_bytes: int = 16 * 2**30,
        rules: shrd.ShardingRules = shrd.DEFAULT_RULES,
        context: Optional[DiompContext] = None,
        install_default: bool = True,
    ):
        # the runtime is a registration layer over ONE DiompContext; it
        # installs that context as the process default, so the
        # paper-verbatim free functions and the registered tensors share
        # one table (the Fig. 1b "deep integration"); a context of other
        # settings (allocator, streams) is passed in as ``context``
        if context is None:
            context = DiompContext(mesh=mesh, device=device,
                                   segment_bytes=segment_bytes)
        if install_default:
            _install_default(context)
        self.ctx = context
        self.mesh = context.mesh if context.mesh is not None else mesh
        self.device = context.device
        self.rules = rules
        self.ndev = context.ndev
        self.memory = context.memory
        self.groups: Dict[str, DiompGroup] = context.groups
        self.streams = context.streams
        self.poller = context.poller
        self.rma = context.rma
        self.ccl = context.comms
        self._table: Dict[str, RegisteredTensor] = {}

    # -- group management ----------------------------------------------------
    def group(self, name: str) -> DiompGroup:
        return self.groups[name]

    def add_group(self, name: str, group: DiompGroup) -> DiompGroup:
        return self.ctx.add_group(name, group)

    def communicator(self, group, backend=None):
        """The OMPCCL communicator handle (delegates to the context)."""
        return self.ctx.communicator(group, backend)

    # -- registration (the Fig. 1(b) mapping table) ---------------------------
    def register(
        self,
        name: str,
        shape: Sequence[int],
        dtype: str,
        logical_axes: Sequence[Optional[str]],
        *,
        group: Optional[DiompGroup] = None,
        symmetric: bool = True,
        sizes: Optional[Sequence[int]] = None,
    ) -> RegisteredTensor:
        """Plan a tensor into the PGAS space; returns its table row.

        Symmetric (default): every rank holds an identically-sized shard —
        parameters, optimizer state, activations.  Asymmetric: per-rank
        sizes differ (``sizes`` required) — KV pages, ragged serving state.
        """
        if name in self._table:
            raise ValueError(f"tensor {name!r} already registered")
        group = group or self.groups["world"]
        spec = shrd.logical_to_spec(logical_axes, self.mesh, self.rules)
        if symmetric:
            nbytes = shrd.param_bytes_per_device(
                shape, dtype_bytes(dtype), logical_axes, self.mesh,
                self.rules)
            region: Any = self.memory.alloc_symmetric(
                name, nbytes, group, tuple(logical_axes), dtype)
        else:
            if sizes is None:
                raise ValueError(
                    "asymmetric registration requires per-device sizes")
            region = self.memory.alloc_asymmetric(
                name, list(sizes), group, tuple(logical_axes), dtype)
        row = RegisteredTensor(name=name, shape=tuple(shape), dtype=dtype,
                               logical_axes=tuple(logical_axes), spec=spec,
                               region=region, group=group)
        self._table[name] = row
        self.rma.register(name)
        return row

    def register_pytree(
        self,
        prefix: str,
        shapes: Dict[str, Tuple[Tuple[int, ...], str,
                                Tuple[Optional[str], ...]]],
        *,
        group: Optional[DiompGroup] = None,
    ) -> Dict[str, RegisteredTensor]:
        return {
            k: self.register(f"{prefix}/{k}", shp, dt, axes, group=group)
            for k, (shp, dt, axes) in shapes.items()
        }

    def release(self, name: str) -> None:
        row = self._table.pop(name)
        self.memory.free(row.region)

    # -- placement -------------------------------------------------------------
    def sharding_for(self, name_or_axes) -> shrd.RankSharding:
        if isinstance(name_or_axes, str):
            spec = self._table[name_or_axes].spec
        else:
            spec = shrd.logical_to_spec(name_or_axes, self.mesh, self.rules)
        return shrd.RankSharding(self.mesh, spec)

    def place(self, name: str, value) -> torch.Tensor:
        """A host value laid out by its registered spec: the stacked tensor
        on the context's device."""
        return stack_shards(value, self.mesh, self.sharding_for(name).spec,
                            device=self.device)

    # -- synchronization -------------------------------------------------------
    def fence(self, timeout_s: float = 120.0) -> None:
        """Host-side ompx_fence: drain streams, every registered poll source
        and the card's stream."""
        self.ctx.fence(timeout_s=timeout_s)

    # -- introspection ---------------------------------------------------------
    def table(self) -> List[RegisteredTensor]:
        return list(self._table.values())

    def lookup(self, name: str) -> RegisteredTensor:
        return self._table[name]

    def bytes_in_use(self, device: int = 0) -> int:
        return self.memory.bytes_in_use(device)

    def report(self) -> str:
        lines = [
            f"DiompRuntime: {self.ndev} ranks on {self.device}, mesh "
            f"{self.mesh.shape}",
            f"heap: {self.bytes_in_use() / 2**20:.1f} MiB/rank in "
            f"{len(self._table)} regions",
        ]
        for row in self._table.values():
            lines.append(
                f"  {row.name:<40s} {str(row.shape):<24s} {row.dtype:<9s} "
                f"spec={row.spec} group={row.group.name} "
                f"{'sym' if row.symmetric else 'asym'}")
        return "\n".join(lines)

    def close(self) -> None:
        self.ctx.close()
