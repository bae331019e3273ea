"""RWKV6 "Finch" on stacked ranks — attention-free LM with data-dependent
decay (the reference's ``repro/models/rwkv.py``).

Manual-SPMD layout: heads (d / rwkv_head_dim) sharded over "model"; the
d→d projections are Megatron column shards; the channel mix is column →
row with an explicit all-gather of each rank's slice; per-channel decay
and bonus vectors live in projection output space so they shard with the
heads.  The WKV recurrence runs through :mod:`repro_torch.kernels.
linear_scan` (the chunked scan kernel on the card, for prefill and decode
alike; the sequential scan on the CPU): state S_t = diag(w_t)·S_{t-1} +
k_tᵀv_t, readout r_t·(S_{t-1} + diag(u)·k_tᵀv_t).

The reference scans its layer stack (``lax.scan``); the port runs a Python
loop over per-layer views, its first layer recorded against the active
context and later layers against its scratch context
(:func:`~repro_torch.core.context.recorded_once`), so one built step logs
what one reference trace does.  Decode state per layer: the token-shift
carries ``x_tm``/``x_cm`` ``(*mesh, B, d)`` and the WKV state ``S``
``(*mesh, B, H_loc, hd, hd)`` in f32, stacked over the layers.  The
training loss is still to port (ROADMAP queue 1, item 19).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import ompccl
from ..core.context import default_context, recorded_once
from ..kernels.linear_scan.ops import linear_scan
from .config import ModelConfig, ParallelCtx
from .layers import (_lift, _rank_index, col_matmul, dot_f32, embed_lookup,
                     flat_heads, layernorm, rmsnorm, row_matmul)
from .transformer import _layer

__all__ = ["rwkv_forward", "rwkv_loss", "rwkv_init_state", "rwkv_decode"]


def _token_shift(x, prev_last):
    """x_{t-1} along T; position 0 uses ``prev_last (*mesh, B, d)``."""
    dt = torch.promote_types(x.dtype, prev_last.dtype)
    return torch.cat([prev_last.unsqueeze(-2).to(dt), x[..., :-1, :].to(dt)],
                     dim=-2)


def _per_head_norm(y, scale_loc, eps):
    """GroupNorm(H) analogue: layernorm within each head's hd channels;
    y ``(*mesh, B, T, H_loc, hd)``, scale_loc ``(*mesh, H_loc·hd)``."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    out = (yf - mu) * torch.rsqrt(var + eps)
    scale = scale_loc.reshape(*scale_loc.shape[:-1], *y.shape[-2:])
    return (out * _lift(scale, y).float()).to(y.dtype)


def rwkv_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx,
               state: Optional[dict] = None):
    """One RWKV6 block on ``x (*mesh, B, T, d)``; returns (x', state')."""
    nd = default_context().require_mesh().ndim
    lead = x.shape[:nd]
    B, T, d = x.shape[nd:]
    hd = cfg.rwkv_head_dim
    H_loc = d // hd // ctx.tp
    d_loc = d // ctx.tp

    # ---- time mix --------------------------------------------------------
    xs = layernorm(x, lp["ln1"], cfg.norm_eps)
    prev = state["x_tm"] if state is not None else xs.new_zeros(*lead, B, d)
    shifted = _token_shift(xs, prev)
    mu = lp["tm_mu"].float()                           # (*mesh, 5, d)
    xsf = xs.float()
    delta = shifted.float() - xsf

    def mix(j):
        return (xsf + _lift(mu.select(-2, j), xs) * delta).to(x.dtype)

    xr, xk, xv, xw, xg = (mix(j) for j in range(5))
    r = col_matmul(xr, lp["tm_wr"], ctx)               # (*mesh, B, T, d_loc)
    k = col_matmul(xk, lp["tm_wk"], ctx)
    v = col_matmul(xv, lp["tm_wv"], ctx)
    g = F.silu(col_matmul(xg, lp["tm_wg"], ctx).float())

    # data-dependent decay (LoRA): w = exp(-exp(w0 + tanh(xw A) B))
    low = torch.tanh(dot_f32(xw, lp["tm_wA"]))
    w_log = _lift(lp["tm_w0"], xw).float() + dot_f32(low, lp["tm_wB"])
    w = torch.exp(-torch.exp(w_log))                   # in (0, 1)

    def heads(t):  # (*mesh, B, T, d_loc) f32 -> (ranks·B·H_loc, T, hd)
        return flat_heads(t.float().reshape(*lead, B, T, H_loc, hd))

    s0 = None if state is None else state["S"].reshape(-1, hd, hd).contiguous()
    y, s_fin = linear_scan(heads(v), heads(k), heads(w), heads(r), s0,
                           readout_pre=True)
    # diag(u) bonus: y_t += v_t * sum_n(r_t u k_t)
    u = lp["tm_u"].float().reshape(*lead, H_loc, hd)
    rk = (r.float() * k.float()).reshape(*lead, B, T, H_loc, hd)
    bonus = (rk * _lift(u, rk)).sum(-1)                # (*mesh, B, T, H_loc)
    y = y.reshape(*lead, B, H_loc, T, hd).transpose(-3, -2)
    y = y + bonus[..., None] * v.float().reshape(*lead, B, T, H_loc, hd)

    y = _per_head_norm(y.to(x.dtype), lp["tm_lnx"], cfg.norm_eps)
    y = (y.reshape(*lead, B, T, d_loc).float() * g).to(x.dtype)
    x = x + row_matmul(y, lp["tm_wo"], ctx)

    # ---- channel mix -----------------------------------------------------
    xs2 = layernorm(x, lp["ln2"], cfg.norm_eps)
    prev2 = state["x_cm"] if state is not None else xs2.new_zeros(*lead, B, d)
    shifted2 = _token_shift(xs2, prev2)
    cmu = lp["cm_mu"].float()                          # (*mesh, 2, d)
    xs2f = xs2.float()
    delta2 = shifted2.float() - xs2f
    xk2 = (xs2f + _lift(cmu.select(-2, 0), xs2) * delta2).to(x.dtype)
    xr2 = (xs2f + _lift(cmu.select(-2, 1), xs2) * delta2).to(x.dtype)
    kk = col_matmul(xk2, lp["cm_wk"], ctx).float()
    kk = torch.square(torch.relu(kk)).to(x.dtype)
    vv = row_matmul(kk, lp["cm_wv"], ctx)              # (*mesh, B, T, d) full
    rr = torch.sigmoid(col_matmul(xr2, lp["cm_wr"], ctx).float())
    if ctx.tp > 1:
        off = _rank_index(ctx.tp_group, vv.dim(), vv.device) * d_loc
        idx = off + torch.arange(d_loc, device=vv.device)
        vv_loc = torch.gather(vv, -1, idx.expand(*vv.shape[:-1], d_loc))
        out2 = ompccl.allgather((rr * vv_loc.float()).to(x.dtype),
                                ctx.tp_group, axis=2, invariant=ctx.inference)
    else:
        out2 = (rr * vv.float()).to(x.dtype)
    x = x + out2

    new_state = None
    if state is not None:
        new_state = {"x_tm": xs[..., -1, :], "x_cm": xs2[..., -1, :],
                     "S": s_fin.reshape(*lead, B, H_loc, hd, hd)}
    return x, new_state


def rwkv_forward(params: Dict[str, torch.Tensor], tokens, cfg: ModelConfig,
                 ctx: ParallelCtx, state: Optional[dict] = None):
    """tokens ``(*mesh, B, T)`` -> (hidden ``(*mesh, B, T, d)``, new state
    or None).  ``state`` (stacked per layer) enables prefill and decode;
    None for a stateless forward."""
    nd = default_context().require_mesh().ndim
    x = embed_lookup(tokens, params["embed/table"], cfg, ctx)
    x = layernorm(x, params["embed_norm"], cfg.norm_eps)
    new = []
    for l in range(cfg.num_layers):
        st = None if state is None else {
            k: v.select(nd, l) for k, v in state.items()}
        with recorded_once(l == 0):
            x, st2 = rwkv_block(x, _layer(params, "layers", nd, l), cfg, ctx,
                                st)
        new.append(st2)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if state is None:
        return x, None
    return x, {k: torch.stack([s[k] for s in new], dim=nd) for k in state}


def rwkv_loss(params, batch, cfg: ModelConfig, ctx: ParallelCtx):
    raise NotImplementedError(
        "the RWKV training loss (the linear scan's backward) is not ported "
        "yet: ROADMAP queue 1, item 19")


def rwkv_init_state(cfg: ModelConfig, ctx: ParallelCtx, B_loc: int, *,
                    dtype=torch.bfloat16, device=None):
    """A zeroed decode state on the active context's mesh: per rank
    ``x_tm``/``x_cm`` ``(L, B_loc, d)`` in ``dtype`` and ``S`` ``(L, B_loc,
    H_loc, hd, hd)`` in f32."""
    dctx = default_context()
    mesh = dctx.require_mesh()
    device = dctx.device if device is None else device
    d, hd, L = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    H_loc = d // hd // ctx.tp
    lead = (*mesh.sizes, L, B_loc)
    return {"x_tm": torch.zeros(*lead, d, dtype=dtype, device=device),
            "x_cm": torch.zeros(*lead, d, dtype=dtype, device=device),
            "S": torch.zeros(*lead, H_loc, hd, hd, dtype=torch.float32,
                             device=device)}


def rwkv_decode(params, tokens, cfg, ctx, state):
    """One decode step ``(*mesh, B, 1)`` -> (local logits, new state)."""
    h, state = rwkv_forward(params, tokens, cfg, ctx, state)
    return dot_f32(h, params["lm_head"]), state
