"""Plain PyTorch oracle for the Minimod acoustic-isotropic 25-point stencil.

8th-order central differences in space (radius 4 per axis -> 25-point star),
2nd order in time:

    u_next = 2 u - u_prev + (c dt)^2 * laplacian(u)

Boundaries are zero-padded (homogeneous Dirichlet).  Every function works on
the last three dims ``(Z, Y, X)``; leading dims (ranks) are a batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["COEFFS", "RADIUS", "laplacian_ref", "wave_step_ref"]

# 8th-order second-derivative coefficients (center + 4 neighbors per side)
COEFFS = (-205.0 / 72.0, 8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)
RADIUS = 4


def laplacian_ref(u: torch.Tensor, *, dx: float = 1.0) -> torch.Tensor:
    """25-point star laplacian with zero boundary halo."""
    R = RADIUS
    up = F.pad(u, (R, R, R, R, R, R))
    z, y, x = u.shape[-3:]
    c0, *cs = COEFFS
    lap = 3.0 * c0 * u
    for r, c in zip(range(1, R + 1), cs):
        for axis in range(3):
            lo = [slice(R, R + z), slice(R, R + y), slice(R, R + x)]
            hi = list(lo)
            ext = (z, y, x)[axis]
            lo[axis] = slice(R - r, R - r + ext)
            hi[axis] = slice(R + r, R + r + ext)
            lap = lap + c * (up[(..., *lo)] + up[(..., *hi)])
    return lap / (dx * dx)


def wave_step_ref(u: torch.Tensor, u_prev: torch.Tensor, c2dt2, *,
                  dx: float = 1.0) -> torch.Tensor:
    """One leapfrog step; c2dt2 = (c·dt)² (scalar or (Z,Y,X) velocity model)."""
    return (2.0 * u - u_prev + c2dt2 * laplacian_ref(u, dx=dx)).to(u.dtype)
