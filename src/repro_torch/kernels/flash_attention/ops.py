"""Public flash attention (the reference's ``flash_attention``, ops.py:40).

Layout contract with the model stack: ``(..., B, T, H, D)`` in,
``(..., B, T, H, Dv)`` out; leading dims are ranks of a stacked tensor.
``impl="cuda"`` (the default and the only local path) is the hand-written
kernel on CUDA tensors and the plain version on CPU tensors; it takes
``q_offset`` and ``valid_len`` as ints or per-row tensors (decode).
``impl="ring"``, the sequence-parallel path, is not ported yet (ROADMAP
queue 1, item 13).  The reference's ``"ref"`` and ``"pallas"`` are refused,
so no caller reaches the plain version on the card.

``block=None`` lets the kernel wrapper take the planner's key tile
(:meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_attention_block`);
the plain version folds the same number of keys per update.
"""

from __future__ import annotations

from typing import Optional

from .kernel import flash_attention_kernel

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    prefix_len: int = 0, scale: Optional[float] = None,
                    impl: str = "cuda", block: Optional[int] = None,
                    valid_len=None, interpret: Optional[bool] = None,
                    group=None, q_sharded: bool = True):
    """q (..., B, Tq, H, D); k (..., B, Tk, KH, D); v (..., B, Tk, KH, Dv).

    ``interpret``, ``group`` and ``q_sharded`` keep the reference's
    signature: the CUDA kernel has no interpret mode (CPU tensors take the
    plain version), and the other two belong to ``impl="ring"``.
    """
    if impl == "ring":
        raise NotImplementedError(
            "impl='ring' (fused ring attention over the sequence-parallel "
            "group) is not ported yet: ROADMAP queue 1, item 13")
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}: the port's local flash "
                         f"attention is impl='cuda'")
    if interpret:
        raise ValueError("the CUDA kernel has no interpret mode: pass CPU "
                         "tensors to run the plain version")
    del group, q_sharded
    return flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset,
                                  prefix_len=prefix_len, scale=scale,
                                  block=block, valid_len=valid_len)
