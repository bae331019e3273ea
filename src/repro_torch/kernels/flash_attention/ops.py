"""Public flash attention (the reference's ``flash_attention``, ops.py:40).

Layout contract with the model stack: ``(..., B, T, H, D)`` in,
``(..., B, T, H, Dv)`` out; leading dims are ranks of a stacked tensor.
``impl="cuda"`` (the default and the only local path) is the hand-written
kernel on CUDA tensors and the plain version on CPU tensors; it takes
``q_offset`` and ``valid_len`` as ints or per-row tensors (decode).
``impl="ring"`` is the sequence-parallel path: per-rank K/V shards rotate
through :func:`~repro_torch.kernels.ring_attention.ring_attention` over
``group`` (``q_sharded`` picks the training or the chunked-prefill query
layout).  The reference's ``"ref"`` and ``"pallas"`` are refused, so no
caller reaches the plain version on the card.

``block=None`` lets the kernel wrapper take the planner's key tile
(:meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_attention_block`);
the plain version folds the same number of keys per update.
"""

from __future__ import annotations

from typing import Optional

from ..ring_attention.ops import ring_attention
from .kernel import flash_attention_kernel

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    prefix_len: int = 0, scale: Optional[float] = None,
                    impl: str = "cuda", block: Optional[int] = None,
                    valid_len=None, interpret: Optional[bool] = None,
                    group=None, q_sharded: bool = True):
    """q (..., B, Tq, H, D); k (..., B, Tk, KH, D); v (..., B, Tk, KH, Dv).

    ``interpret`` keeps the reference's signature: the CUDA kernels have no
    interpret mode (CPU tensors take the plain version).  ``group`` and
    ``q_sharded`` belong to ``impl="ring"``.
    """
    if interpret:
        raise ValueError("the CUDA kernel has no interpret mode: pass CPU "
                         "tensors to run the plain version")
    if impl == "ring":
        if group is None:
            raise ValueError(
                "impl='ring' is the sequence-parallel path: pass the "
                "DiompGroup whose axis the K/V stripes rotate over")
        if prefix_len:
            raise ValueError(
                "impl='ring' does not take prefix_len: bidirectional "
                "prefix attention needs the full K/V, use the all-gather "
                "path (seq_parallel='allgather') for prefix architectures")
        return ring_attention(q, k, v, group, causal=causal,
                              q_offset=q_offset, valid_len=valid_len,
                              scale=scale, q_sharded=q_sharded)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}: the port's local flash "
                         f"attention is impl='cuda'")
    return flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset,
                                  prefix_len=prefix_len, scale=scale,
                                  block=block, valid_len=valid_len)
