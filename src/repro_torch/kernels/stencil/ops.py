"""Public wrapper for the acoustic wave step.

``impl="cuda"`` is the hand-written kernel (the counterpart of the
reference's ``impl="pallas"``); ``impl="ref"`` the plain oracle.
"""

from __future__ import annotations

import torch

from .fused import exchange_halos, fused_wave_step  # noqa: F401 - re-export
from .kernel import C2, wave_step_kernel
from .ref import wave_step_ref

__all__ = ["wave_step", "fused_wave_step", "exchange_halos"]


def wave_step(u: torch.Tensor, u_prev: torch.Tensor, c2dt2: C2, *,
              dx: float = 1.0, impl: str = "ref") -> torch.Tensor:
    """u, u_prev: (..., Z, Y, X); c2dt2 scalar or field-shaped.  One step."""
    if impl == "ref":
        return wave_step_ref(u, u_prev, c2dt2, dx=dx)
    if impl == "cuda":
        return wave_step_kernel(u, u_prev, c2dt2, dx=dx)
    raise ValueError(impl)
