"""The rank mesh: named axes with sizes, laid out as leading tensor dims.

The reference builds a ``jax`` device mesh; here one card holds every
rank, so a mesh is only names and sizes.  A stacked tensor over a mesh has
``len(axis_names)`` leading dimensions, one per axis in mesh order, followed
by the per-rank (local) dimensions.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

__all__ = ["RankMesh", "make_production_mesh", "make_smoke_mesh"]


class RankMesh:
    """Named mesh axes with sizes (the counterpart of ``jax.sharding.Mesh``)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(axis_names) != len(sizes):
            raise ValueError(f"axes {axis_names} vs sizes {sizes} rank mismatch")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axes {axis_names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.sizes: Tuple[int, ...] = sizes

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in mesh order (as ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def size(self) -> int:
        """Number of ranks."""
        return math.prod(self.sizes)

    def dim(self, axis: str) -> int:
        """Leading tensor dimension that carries ``axis``."""
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(
                f"axis {axis!r} not in mesh {self.axis_names}") from None

    def __eq__(self, other) -> bool:
        return isinstance(other, RankMesh) and \
            (self.axis_names, self.sizes) == (other.axis_names, other.sizes)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.sizes))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"RankMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """16x16 = 256 ranks per pod; multi_pod prepends a 2-pod axis (512)."""
    if multi_pod:
        return RankMesh(("pod", "data", "model"), (2, 16, 16))
    return RankMesh(("data", "model"), (16, 16))


def _smoke_shape(ndev: int, pods: bool) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
    if pods and ndev % 4 == 0:
        return (2, ndev // 4, 2), ("pod", "data", "model")
    return (max(ndev // 2, 1), min(ndev, 2)), ("data", "model")


def make_smoke_mesh(ndev: int = 8, *, pods: bool = True) -> RankMesh:
    """Small mesh for tests and examples (8 virtual ranks by default)."""
    if ndev <= 0:
        raise ValueError(f"ndev must be positive, got {ndev}")
    shape, axes = _smoke_shape(ndev, pods)
    return RankMesh(axes, shape)
