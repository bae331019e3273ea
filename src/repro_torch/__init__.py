"""DiOMP runtime ported to PyTorch and CUDA, one H100 standing in for the mesh.

The runtime entry point is the communicator-handle API::

    import repro_torch as diomp

    ctx = diomp.init(mesh=RankMesh(("x",), (4,)))   # device="cuda" by default
    comm = ctx.communicator(group)                   # OMPCCL handle

Per-rank data is a stacked tensor whose leading dimensions are the mesh
axes, in mesh order (see :mod:`repro_torch.launch.mesh`).  Every entry
point runs on the card unless the caller passes ``device="cpu"``.
"""

from .core.context import (Communicator, DiompContext, default_context,
                           init, reset_default_context, use_default)
from .core.faults import ChaosBackend, FaultPlan, FaultSpec
from .core.resilience import RetryPolicy

__all__ = [
    "init",
    "DiompContext",
    "Communicator",
    "default_context",
    "use_default",
    "reset_default_context",
    "FaultPlan",
    "FaultSpec",
    "ChaosBackend",
    "RetryPolicy",
]
