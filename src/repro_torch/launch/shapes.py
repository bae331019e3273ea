"""Minimod application cells: grid extents plus the (Z×Y) decomposition,
including the heterogeneous-rank cells whose asymmetric Z extents exercise
the PGAS asymmetric-allocation path (consumed by
:mod:`repro_torch.apps.minimod`).  The reference's LM shape cells belong to
its model stack, which this package does not carry yet."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["STENCIL_SHAPES", "StencilShape"]


@dataclasses.dataclass(frozen=True)
class StencilShape:
    """One Minimod cell: global grid + (Z×Y) decomposition + time steps.

    ``weights`` (optional) makes the Z decomposition *asymmetric*: rank i
    owns a subdomain proportional to ``weights[i]``.  ``ny > 1`` additionally
    splits the Y axis (symmetric) for the 2-D decomposition.
    """

    name: str
    grid: Tuple[int, int, int]          # Z, Y, X
    steps: int
    nz: int
    ny: int = 1
    weights: Optional[Tuple[int, ...]] = None

    @property
    def ranks(self) -> int:
        return self.nz * self.ny


STENCIL_SHAPES = {
    "minimod_64": StencilShape("minimod_64", (64, 64, 64), 10, 8),
    "minimod_2d": StencilShape("minimod_2d", (64, 32, 64), 10, 4, ny=2),
    "minimod_hetero": StencilShape(
        "minimod_hetero", (60, 48, 48), 10, 4, weights=(3, 2, 2, 1)),
    "minimod_smoke": StencilShape("minimod_smoke", (48, 16, 16), 3, 4),
}
