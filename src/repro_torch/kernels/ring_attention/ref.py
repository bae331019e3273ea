"""Single-device plain version executing the exact stripe/merge chain.

``flash_attention_ref`` folds K/V blocks with the online update, so its
rounding differs from the ring's state merge in the last ulp.  This plain
version replays, on one device over the full tensors, the computation every
ring rank performs: one :func:`~.kernel.stripe_state` per K/V stripe, folded
with :func:`~.kernel.merge_states` in the ring's schedule order
(:meth:`AttentionRingPlan.sources`).  The emulation (:mod:`.fused`) is
therefore equal to it bit for bit, and both are within float tolerance of
flash attention.

It carries the emulation's hand-written gradient (:func:`~.kernel.
chain_grads` a rank, each stripe's K/V cotangents summed in the canonical
order: the owner's own stripe, then the clockwise deliveries by ascending
step, then the counter-clockwise ones), so the bit contract holds for the
gradients too.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..plan import AttentionRingPlan
from .kernel import (chain_grads, custom_vjp, empty_state, finalize_state,
                     merge_states, scaled_queries, stripe_mask, stripe_state)

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
    R = n if q_sharded else 1
    folds = plan.fold_steps()
    G = H // KH

    def rank_stripes(r, k, v):
        """Rank r's fold-order ``(k, v, vis)`` stripes."""
        q_pos = offset + (r * tq_loc if q_sharded else 0) \
            + torch.arange(tq_loc, device=dev)
        out = []
        for src in plan.sources(r):
            vis = stripe_mask(tk_loc, q_pos=q_pos, k_start=src * tk_loc,
                              causal=causal, valid_len=valid_len)
            rows = slice(src * tk_loc, (src + 1) * tk_loc)
            out.append((k[:, rows], v[:, rows],
                        vis.expand(B, tq_loc, tk_loc)))
        return out

    def rank_q(r, t):
        return t[:, r * tq_loc:(r + 1) * tq_loc] if q_sharded else t

    def run(q, k, v):
        outs = []
        for r in range(R):
            qg = scaled_queries(rank_q(r, q), KH, scale)
            state = empty_state(qg, Dv)
            for k_str, v_str, vis in rank_stripes(r, k, v):
                state = merge_states(state, stripe_state(qg, k_str, v_str,
                                                         vis))
            outs.append(finalize_state(state, q.dtype))
        return torch.cat(outs, dim=1) if q_sharded else outs[0]

    def grads(q, k, v, ct):
        ct32 = ct.float()
        gq, gks, gvs = [], [], []
        for r in range(R):
            gqg, gk_r, gv_r = chain_grads(
                scaled_queries(rank_q(r, q), KH, scale),
                rank_stripes(r, k, v),
                rank_q(r, ct32).reshape(B, tq_loc, KH, G, Dv))
            gq.append((gqg.reshape(B, tq_loc, H, D) * scale).to(q.dtype))
            gks.append(gk_r)
            gvs.append(gv_r)
        own = folds.index(("cw", 0))
        gk_stripes, gv_stripes = [], []
        for p in range(n):
            if q_sharded:
                # the emulation's canonical sum at the owner: own stripe,
                # then cw deliveries, then ccw
                gk_p, gv_p = gks[p][own], gvs[p][own]
                for want in ("cw", "ccw"):
                    for i, (dirn, s) in enumerate(folds):
                        if dirn != want or s == 0:
                            continue
                        rr = (p + s) % n if dirn == "cw" else (p - s) % n
                        gk_p = gk_p + gks[rr][i]
                        gv_p = gv_p + gvs[rr][i]
            else:
                i = plan.sources(0).index(p)
                gk_p, gv_p = gks[0][i], gvs[0][i]
            gk_stripes.append(gk_p)
            gv_stripes.append(gv_p)
        return (torch.cat(gq, dim=1) if q_sharded else gq[0],
                torch.cat(gk_stripes, dim=1).to(k.dtype),
                torch.cat(gv_stripes, dim=1).to(v.dtype))

    return custom_vjp(run, grads, q, k, v)
