"""Oracles and routing helpers of the MoE dispatch kernel family.

The single-device oracle (:func:`moe_ref`) computes the dropless top-k MoE
exactly: every (token, choice) pair reaches its expert, with no capacity
and no dispatch.  The one-sided dispatch must match it bit for bit under
imbalanced routing, because dropless dispatch only moves data.

:func:`route_topk` is ``moe_block``'s router (f32 softmax, top-k,
renormalized weights), and :func:`measure_expert_load` turns concrete
routing into the per-expert load vector that
:meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_alltoall` sizes the
asymmetric landing regions from.  :func:`expert_mlp_bwd_plain` is the
gradient of the expert-MLP kernel's function as its backward kernel
computes it (``csrc/expert_mlp_bwd.cu``).  Every function takes any leading
(rank) dims.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["expert_mlp_ref", "expert_mlp_bwd_plain", "live_rows",
           "route_topk", "measure_expert_load", "moe_ref"]


def _lift(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weights ``(*W, E, a, b)`` viewed to broadcast against x's dims."""
    extra = x.dim() - w.dim()
    return w.reshape(*w.shape[:-3], *([1] * extra), *w.shape[-3:])


def live_rows(counts: torch.Tensor, C: int) -> torch.Tensor:
    """``(..., E, C)`` mask of the rows below each expert's count."""
    return torch.arange(C, device=counts.device) < counts[..., None]


def expert_mlp_ref(x, wg, wu, wd):
    """Grouped silu-gated expert MLP in the operands' dtype, the
    reference's einsum form.

    ``x (..., E, C, d)``, ``wg/wu (..., E, d, f)``, ``wd (..., E, f, d)``
    -> ``(..., E, C, d)``; the weights' leading dims match x's.
    """
    h = F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
    return torch.matmul(h, wd)


def expert_mlp_bwd_plain(x, wg, wu, wd, dy,
                         counts: Optional[torch.Tensor] = None):
    """The gradient of the expert-MLP kernel's function, as its backward
    kernel computes it: ``(dx, dwg, dwu, dwd)`` for the cotangent ``dy`` of
    ``y = (silu(x wg) * (x wu)).astype(x) @ wd``.

    Layouts as the forward's (``x, dy (*W, *S, E, C, d)``, weights ``(*W,
    E, ...)``); dx comes out like x and each dW in its weight's shape, all
    in x's dtype, dW summed over every S source.  g and u are recomputed in
    f32; ``dh = dy wd^T`` in f32; ``dg = dh u silu'(g)`` and ``du = dh
    silu(g)`` in f32, rounded to x's dtype, as is ``h``, before the products
    the kernel runs on the tensor cores (``dx = dg wg^T + du wu^T``, ``dwg =
    x^T dg``, ``dwu = x^T du``, ``dwd = h^T dy``, each accumulated in f32 and
    rounded once).  Rows at or past ``counts`` give zero dx and add nothing
    to dW.  In f32 every rounding is the identity: this is autograd's
    gradient of the forward's plain version."""
    dt = x.dtype
    C, d = x.shape[-2:]
    f = wg.shape[-1]
    nw = wg.dim() - 3
    xf = x.float()
    wgf, wuf, wdf = (_lift(w, x).float() for w in (wg, wu, wd))
    g = torch.matmul(xf, wgf)
    u = torch.matmul(xf, wuf)
    s = torch.sigmoid(g)
    silu = g * s
    dyf = dy.float()
    if counts is not None:
        live = live_rows(counts, C)[..., None]
        dyf = dyf.masked_fill(~live, 0)
    dh = torch.matmul(dyf, wdf.transpose(-1, -2))
    h = (F.silu(g) * u).to(dt)
    dg = (dh * u * (s * (1 + g * (1 - s)))).to(dt)
    du = (dh * silu).to(dt)
    if counts is not None:
        h, dg, du = (t.masked_fill(~live, 0) for t in (h, dg, du))
    dx = (torch.matmul(dg.float(), wgf.transpose(-1, -2))
          + torch.matmul(du.float(), wuf.transpose(-1, -2))).to(dt)
    if counts is not None:
        dx = dx.masked_fill(~live, 0)
    # dW: every source's rows of an expert, (*W, S, E, C, .) flattened
    lead = x.shape[:nw]
    rows = (*lead, -1, x.shape[-3], C)
    xs, dgs, dus, hs, dys = (t.float().reshape(*rows, t.shape[-1])
                             for t in (xf, dg, du, h, dyf))
    del g, u, s, silu, dh
    dwg = torch.einsum("...secd,...secf->...edf", xs, dgs).to(dt)
    dwu = torch.einsum("...secd,...secf->...edf", xs, dus).to(dt)
    dwd = torch.einsum("...secf,...secd->...efd", hs, dys).to(dt)
    return dx, dwg.reshape(wg.shape), dwu.reshape(wu.shape), \
        dwd.reshape(wd.shape)


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
