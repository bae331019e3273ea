"""Plain PyTorch versions of the matmul kernels and the ring's oracle."""

from __future__ import annotations

import torch

from ...core import ompccl
from ...core.groups import DiompGroup

__all__ = ["matmul_ref", "ring_allgather_matmul_plain",
           "ring_allgather_matmul_ref"]


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32-accumulated matmul, output in the input dtype — the plain
    version of the matmul kernel (batched over leading dims)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def ring_allgather_matmul_plain(x: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused ring kernel on stacked ranks:
    ``x (n, t_loc, K)``, ``w (n, K, n_loc)`` -> ``(n, n·t_loc, n_loc)``,
    every rank's column block of the all-gathered X times its W."""
    n, t_loc, k = x.shape
    return matmul_ref(x.reshape(n * t_loc, k), w)


def ring_allgather_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                              group: DiompGroup) -> torch.Tensor:
    """Unoverlapped baseline: all-gather X, then one local matmul."""
    x_full = ompccl.allgather(x, group, axis=0)
    return matmul_ref(x_full, w)
