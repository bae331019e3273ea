"""Single-device plain version executing the exact stripe/merge chain.

``flash_attention_ref`` folds K/V blocks with the online update, so its
rounding differs from the ring's state merge in the last ulp.  This plain
version replays, on one device over the full tensors, the computation every
ring rank performs: one :func:`~.kernel.stripe_state` per K/V stripe, folded
with :func:`~.kernel.merge_states` in the ring's schedule order
(:meth:`AttentionRingPlan.sources`).  The emulation (:mod:`.fused`) is
therefore equal to it bit for bit, and both are within float tolerance of
flash attention.  Forward only: the reference's VJP belongs to training.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..plan import AttentionRingPlan
from .kernel import (empty_state, finalize_state, merge_states,
                     scaled_queries, stripe_mask, stripe_state)

__all__ = ["ring_attention_ref"]


def ring_attention_ref(q, k, v, *, n: int, causal: bool = True, q_offset=0,
                       valid_len=None, scale: Optional[float] = None,
                       plan: Optional[AttentionRingPlan] = None,
                       q_sharded: bool = True) -> torch.Tensor:
    """``q (B, Tq, H, D)`` FULL queries; ``k/v (B, Tk, KH, D/Dv)`` FULL
    keys/values, ``Tk`` split into ``n`` equal stripes (pad and pass
    ``valid_len`` for ragged lengths).  With ``q_sharded=True`` rank ``r``
    owns query rows ``[r·Tq/n, (r+1)·Tq/n)`` and the outputs concatenate
    to ``(B, Tq, H, Dv)``; with ``False`` every rank holds the same ``Tq``
    queries at ``q_offset`` (chunked prefill) and the one shared output is
    returned.  ``q_offset`` and ``valid_len`` are ints or ``(B,)`` tensors.
    """
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if Tk % n:
        raise ValueError(f"Tk={Tk} not divisible into {n} stripes")
    tk_loc = Tk // n
    if q_sharded and Tq % n:
        raise ValueError(f"Tq={Tq} not divisible over {n} ranks")
    tq_loc = Tq // n if q_sharded else Tq
    if scale is None:
        scale = D ** -0.5
    if plan is None:
        plan = AttentionRingPlan(n=n, tq_loc=tq_loc, tk_loc=tk_loc, h=H,
                                 kh=KH, d=D, dv=Dv, b=B, causal=causal,
                                 q_sharded=q_sharded)
    dev = q.device
    offset = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
    outs = []
    for r in range(n if q_sharded else 1):
        qr = q[:, r * tq_loc:(r + 1) * tq_loc] if q_sharded else q
        q_pos = offset + (r * tq_loc if q_sharded else 0) \
            + torch.arange(tq_loc, device=dev)
        qg = scaled_queries(qr, KH, scale)
        state = empty_state(qg, Dv)
        for src in plan.sources(r):
            vis = stripe_mask(tk_loc, q_pos=q_pos, k_start=src * tk_loc,
                              causal=causal, valid_len=valid_len)
            rows = slice(src * tk_loc, (src + 1) * tk_loc)
            state = merge_states(state, stripe_state(
                qg, k[:, rows], v[:, rows],
                vis.expand(B, tq_loc, tk_loc)))
        outs.append(finalize_state(state, q.dtype))
    return torch.cat(outs, dim=1) if q_sharded else outs[0]
