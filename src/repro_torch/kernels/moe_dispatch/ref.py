"""Oracles and routing helpers of the MoE dispatch kernel family.

The single-device oracle (:func:`moe_ref`) computes the dropless top-k MoE
exactly: every (token, choice) pair reaches its expert, with no capacity
and no dispatch.  The one-sided dispatch must match it bit for bit under
imbalanced routing, because dropless dispatch only moves data.

:func:`route_topk` is ``moe_block``'s router (f32 softmax, top-k,
renormalized weights), and :func:`measure_expert_load` turns concrete
routing into the per-expert load vector that
:meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_alltoall` sizes the
asymmetric landing regions from.  Every function takes any leading (rank)
dims.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["expert_mlp_ref", "route_topk", "measure_expert_load", "moe_ref"]


def expert_mlp_ref(x, wg, wu, wd):
    """Grouped silu-gated expert MLP in the operands' dtype, the
    reference's einsum form.

    ``x (..., E, C, d)``, ``wg/wu (..., E, d, f)``, ``wd (..., E, f, d)``
    -> ``(..., E, C, d)``; the weights' leading dims match x's.
    """
    h = F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
    return torch.matmul(h, wd)


def route_topk(toks, router, k: int):
    """``moe_block``'s router: f32 softmax, top-k, renormalized weights.

    ``toks (..., t, d)``, ``router (..., d, E)`` -> ``(top_w, top_e)``, each
    ``(..., t, k)``.  ``torch.topk`` over the f32 probabilities gives
    ``lax.top_k``'s indices except where two probabilities tie exactly.
    """
    logits = torch.matmul(toks.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_w, top_e


def measure_expert_load(top_e, E: int, *,
                        sources: Optional[int] = None) -> Tuple[int, ...]:
    """Per-expert landing load from concrete routing (host side, numpy).

    ``top_e`` is one source rank's ``(t_loc, k)`` choices or all sources
    stacked as ``(sources, t_loc, k)``.  Returns, per expert, the MAXIMUM
    rows any single source routes to it: what one per-source slice of the
    expert's landing region must absorb for the dispatch to be dropless.
    """
    a = np.asarray(top_e.cpu() if isinstance(top_e, torch.Tensor) else top_e)
    if a.ndim == 2:
        a = a[None]
    elif sources is not None and a.shape[0] != sources:
        raise ValueError(f"expected {sources} sources, got {a.shape[0]}")
    counts = np.zeros((a.shape[0], E), dtype=np.int64)
    for s in range(a.shape[0]):
        idx, n = np.unique(a[s].reshape(-1), return_counts=True)
        counts[s, idx] = n
    return tuple(int(v) for v in counts.max(axis=0))


def moe_ref(toks, top_e, top_w, wg, wu, wd, *,
            mlp: Optional[Callable] = None):
    """Single-device dropless oracle: every choice reaches its expert.

    ``toks (t, d)``; ``top_e/top_w (t, k)``; ``wg/wu (E, d, f)``,
    ``wd (E, f, d)`` — ALL E experts.  Returns the combined ``(t, d)`` in
    ``toks.dtype``.  ``mlp`` (default :func:`expert_mlp_ref`) is the
    grouped MLP every token runs through.
    """
    mlp = mlp or expert_mlp_ref
    t, d = toks.shape
    E = wg.shape[0]
    x = toks[None].expand(E, t, d).contiguous()
    outs = mlp(x, wg, wu, wd).to(toks.dtype)                   # (E, t, d)
    picked = outs[top_e, torch.arange(t, device=toks.device)[:, None]]
    gates = top_w.to(toks.dtype)[..., None]
    return (picked * gates).sum(dim=1)
