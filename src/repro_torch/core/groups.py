"""DiOMP Groups — communicator-like handles over named rank-mesh axes.

The paper's ``ompx_group_t`` partitions the global communication domain into
subgroups that can be created, split and merged at runtime (§3.3).  A group
is an ordered tuple of mesh axis names; on a stacked tensor it selects the
leading rank dimensions its collectives run over.

* ``WORLD.split("model")``  -> (group over "model", residual group)
* ``merge(g1, g2)``         -> group over the union of axes
* ``group.axis_size(mesh)`` -> number of participants
* ``group.descriptor()``    -> stable identifier (OMPCCL's UniqueID)
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Tuple

from ..launch.mesh import RankMesh

__all__ = [
    "DiompGroup",
    "GroupError",
    "group_for_axes",
    "world_group",
    "merge",
    "standard_groups",
]


class GroupError(ValueError):
    """Raised on invalid group construction (unknown axis, overlap, ...)."""


@dataclasses.dataclass(frozen=True)
class DiompGroup:
    """A communicator handle: an ordered subset of mesh axis names."""

    axes: Tuple[str, ...]
    name: str = ""

    def __post_init__(self):
        if len(set(self.axes)) != len(self.axes):
            raise GroupError(f"duplicate axes in group: {self.axes}")
        if not self.name:
            object.__setattr__(self, "name", "+".join(self.axes) or "self")

    def axis_size(self, mesh: RankMesh) -> int:
        size = 1
        for ax in self.axes:
            if ax not in mesh.shape:
                raise GroupError(f"group axis {ax!r} not in mesh {mesh.axis_names}")
            size *= mesh.shape[ax]
        return size

    def validate(self, mesh: RankMesh) -> "DiompGroup":
        self.axis_size(mesh)  # raises on unknown axis
        return self

    def rank_dims(self, mesh: RankMesh) -> Tuple[int, ...]:
        """The leading tensor dimensions this group spans, in group order."""
        self.validate(mesh)
        return tuple(mesh.dim(ax) for ax in self.axes)

    # -- group algebra (paper §3.3: create / split / merge) ------------------
    def split(self, *axes: str) -> Tuple["DiompGroup", "DiompGroup"]:
        """Split this group into (group over ``axes``, residual group)."""
        for ax in axes:
            if ax not in self.axes:
                raise GroupError(f"cannot split on {ax!r}: not in group {self.axes}")
        picked = tuple(ax for ax in self.axes if ax in axes)
        rest = tuple(ax for ax in self.axes if ax not in axes)
        return DiompGroup(picked), DiompGroup(rest)

    def contains(self, other: "DiompGroup") -> bool:
        return set(other.axes) <= set(self.axes)

    def overlaps(self, other: "DiompGroup") -> bool:
        return bool(set(self.axes) & set(other.axes))

    # -- identity / bootstrap -------------------------------------------------
    def descriptor(self) -> str:
        """Stable unique id for this group (models OMPCCL's UniqueID).

        Memoized on the instance: descriptors key every communicator-table
        lookup."""
        memo = self.__dict__.get("_descriptor")
        if memo is None:
            h = hashlib.sha256(("|".join(self.axes)).encode()).hexdigest()[:16]
            memo = f"diomp-group-{self.name}-{h}"
            object.__setattr__(self, "_descriptor", memo)
        return memo

    def is_self_group(self) -> bool:
        return not self.axes

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"DiompGroup({self.name}: axes={self.axes})"


@functools.lru_cache(maxsize=None)
def group_for_axes(axes: Tuple[str, ...]) -> DiompGroup:
    """Interned group handle for an axis tuple."""
    return DiompGroup(tuple(axes))


def world_group(mesh: RankMesh) -> DiompGroup:
    """The WORLD communicator: all mesh axes in mesh order."""
    return DiompGroup(tuple(mesh.axis_names), name="world")


def merge(*groups: DiompGroup, name: Optional[str] = None) -> DiompGroup:
    """Recompose several disjoint groups into one (paper: group merge)."""
    axes: list = []
    for g in groups:
        for ax in g.axes:
            if ax in axes:
                raise GroupError(f"merge overlap on axis {ax!r}")
            axes.append(ax)
    return DiompGroup(tuple(axes), name=name or "+".join(g.name for g in groups))


def standard_groups(mesh: RankMesh) -> dict:
    """The standard communicators: world, tp/ep, dp, dp_inner, pod."""
    names = set(mesh.axis_names)
    groups = {"world": world_group(mesh)}
    if "model" in names:
        groups["tp"] = DiompGroup(("model",), name="tp")
        groups["ep"] = DiompGroup(("model",), name="ep")
    dp_axes = tuple(ax for ax in ("pod", "data") if ax in names)
    if dp_axes:
        groups["dp"] = DiompGroup(dp_axes, name="dp")
    if "data" in names:
        groups["dp_inner"] = DiompGroup(("data",), name="dp_inner")
    if "pod" in names:
        groups["pod"] = DiompGroup(("pod",), name="pod")
    return groups
