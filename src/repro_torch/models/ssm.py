"""Mamba2 (SSD) blocks and the Zamba2 hybrid (a Mamba stack plus one shared
attention+MLP block) on stacked ranks (the reference's
``repro/models/ssm.py``).

Mamba2 state update per head: h_t = exp(A·Δt)·h_{t-1} + Δt·B_tᵀx_t,
y_t = C_t·h_t + D·x_t — the unified linear scan with a scalar per-head
decay broadcast over the state dim, read out after the update.  The scan runs
through :mod:`repro_torch.kernels.linear_scan` (the kernel on the card, for
prefill and decode alike), with its inputs materialised as the reference
broadcasts them.

Zamba2 wiring: an unrolled Python loop over the Mamba layers (as in the
reference, so every layer's collectives are logged) with the SHARED
attention+MLP block applied after every ``attn_every`` layers; each
application keeps its own KV cache, written in place, and the cache holds
one scalar position a rank.  The shared block's attention runs the port's
``attention_block`` and its flash kernel.

TP: the inner dim (2·d) is sharded over "model" via the head dim; the B/C
projection is small and replicated; the gated output norm reduces its
statistics across TP with an OMPCCL all-reduce.  With ``seq_sharded=True``
the shared block's K/V caches keep ``S / data`` rows a rank (the long
context's decode, :func:`~repro_torch.models.layers.cp_decode_attention`);
the Mamba states are per sequence and stay whole.  The training loss
(:func:`zamba_loss`) checkpoints each Mamba block and each application of
the shared block under ``ctx.remat``; the scan takes the log-decay
``Δt·A``, through which its gradient flows (the backward kernel on the
card).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import ompccl
from ..core.context import default_context
from ..kernels.linear_scan.ops import linear_scan
from .config import ModelConfig, ParallelCtx
from .layers import (KVCache, _lift, attention_block, ce_loss, col_matmul,
                     dot_f32, embed_lookup, flat_heads, gather_fsdp,
                     local_kv_heads, mlp_block, rmsnorm, row_matmul)
from .transformer import _layer, remat

__all__ = ["zamba_forward", "zamba_loss", "zamba_init_state", "zamba_decode"]

MAMBA_HEAD_DIM = 64


def _rmsnorm_tp(x, scale_loc, ctx: ParallelCtx, eps: float):
    """RMSNorm over a TP-sharded channel dim: the statistics all-reduced
    across TP."""
    xf = x.float()
    sq = (xf * xf).sum(-1, keepdim=True)
    n = x.shape[-1] * ctx.tp
    if ctx.tp > 1:
        sq = ompccl.allreduce(sq, ctx.tp_group)
    inv = torch.rsqrt(sq / n + eps)
    return (xf * inv * _lift(scale_loc, x).float()).to(x.dtype)


def _causal_conv(x, w_loc, b_loc, state: Optional[torch.Tensor]):
    """Depthwise causal conv along T: x ``(*mesh, B, T, C_loc)``; w ``(*mesh,
    cw, C_loc)``.  Returns (y, new_state), the state carrying the trailing
    cw-1 inputs."""
    T = x.shape[-2]
    cw = w_loc.shape[-2]
    hist = state if state is not None else x.new_zeros(
        *x.shape[:-2], cw - 1, x.shape[-1])
    dt = torch.promote_types(hist.dtype, x.dtype)
    xp = torch.cat([hist.to(dt), x.to(dt)], dim=-2)   # (.., T + cw - 1, C)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        w_i = _lift(w_loc.select(-2, i), x).float()
        y = y + w_i * xp[..., i:i + T, :].float()
    y = y + _lift(b_loc, x).float()
    new_state = xp[..., -(cw - 1):, :] if cw > 1 else hist
    return y.to(x.dtype), new_state


def mamba_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx,
                state: Optional[dict] = None):
    """One Mamba2 block on ``x (*mesh, B, T, d)``; returns (x', state')."""
    nd = default_context().require_mesh().ndim
    lead = x.shape[:nd]
    B, T, d = x.shape[nd:]
    din_loc = 2 * d // ctx.tp
    hd = MAMBA_HEAD_DIM
    nh_loc = din_loc // hd
    st = cfg.ssm_state

    h = rmsnorm(x, lp["norm"], cfg.norm_eps)
    x_in = col_matmul(h, lp["w_x"], ctx)               # (*mesh, B, T, din_loc)
    z = col_matmul(h, lp["w_z"], ctx)
    bc = dot_f32(h, gather_fsdp(lp["w_bc"], ctx, dim=0))  # replicated, f32
    B_, C_ = bc[..., :st], bc[..., st:]
    dt_raw = col_matmul(h, lp["w_dt"], ctx).float() \
        + _lift(lp["dt_bias"], h).float()
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))   # softplus

    x_c, conv_state = _causal_conv(
        x_in, lp["conv_w"], lp["conv_b"],
        state["conv"] if state is not None else None)
    x_c = F.silu(x_c.float())

    A = -torch.exp(lp["A_log"].float())                # (*mesh, nh_loc)
    log_a = _lift(A, dt) * dt                     # (*mesh, B, T, nh_loc)

    xh = x_c.reshape(*lead, B, T, nh_loc, hd)
    p = xh * dt[..., None]
    shape = (*lead, B, T, nh_loc, st)
    q_in = B_[..., None, :].expand(shape)
    r_in = C_[..., None, :].expand(shape)
    la_in = log_a[..., None].expand(shape)

    s0 = None if state is None else state["S"].reshape(-1, hd, st).contiguous()
    y, s_fin = linear_scan(flat_heads(p), flat_heads(q_in), None,
                           flat_heads(r_in), s0, log_a=flat_heads(la_in),
                           readout_pre=False)
    y = y.reshape(*lead, B, nh_loc, T, hd).transpose(-3, -2)
    y = y + _lift(lp["D"].float()[..., None], y) * xh

    y = y.reshape(*lead, B, T, din_loc)
    y = _rmsnorm_tp(y.to(x.dtype), lp["out_norm"], ctx, cfg.norm_eps)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = row_matmul(y, lp["w_out"], ctx)

    new_state = None
    if state is not None:
        new_state = {"conv": conv_state,
                     "S": s_fin.reshape(*lead, B, nh_loc, hd, st)}
    return x + out, new_state


def _shared_params(params):
    return {k[len("shared/"):]: v for k, v in params.items()
            if k.startswith("shared/")}


def zamba_forward(params: Dict[str, torch.Tensor], tokens, cfg: ModelConfig,
                  ctx: ParallelCtx, cache: Optional[dict] = None, *,
                  seq_sharded: bool = False):
    """Zamba2: L Mamba blocks, the shared attn+MLP after every attn_every.

    ``cache``: ``{"mamba": {"conv", "S"} stacked per layer, "k"/"v":
    (*mesh, n_app, B, S, KH_loc, D), "pos": (*mesh,)}`` — None for a
    stateless forward, whose Mamba blocks and shared-block applications
    are each checkpointed under ``ctx.remat`` with gradients on (the
    reference's ``jax.checkpoint`` of each).  Returns (hidden, new cache);
    K/V go into the cache's tensors in place.
    """
    nd = default_context().require_mesh().ndim
    x = embed_lookup(tokens, params["embed/table"], cfg, ctx)
    T = tokens.shape[-1]
    every = max(cfg.attn_every, 1)
    shared = _shared_params(params)

    pos = cache["pos"] if cache is not None else None
    positions = (pos.reshape(*pos.shape, 1, 1) if cache is not None and T == 1
                 else None)

    checkpointed = ctx.remat and cache is None and torch.is_grad_enabled()

    def shared_block(h, kv=None):
        hn = rmsnorm(h, shared["attn_norm"], cfg.norm_eps)
        attn, _ = attention_block(hn, shared, cfg, ctx, positions=positions,
                                  cache=kv)
        h = h + attn
        hn = rmsnorm(h, shared["mlp_norm"], cfg.norm_eps)
        return h + mlp_block(hn, shared, ctx)

    new_mamba, app = [], 0
    for i in range(cfg.num_layers):
        lp = _layer(params, "layers", nd, i)
        if checkpointed:
            x = remat(lambda h, lp=lp: mamba_block(h, lp, cfg, ctx)[0], x,
                      True)
        else:
            st = None if cache is None else {
                k: v.select(nd, i) for k, v in cache["mamba"].items()}
            x, st2 = mamba_block(x, lp, cfg, ctx, st)
            new_mamba.append(st2)
        if (i + 1) % every == 0:
            if checkpointed:
                x = remat(shared_block, x, True)
            else:
                x = shared_block(x, None if cache is None else KVCache(
                    cache["k"].select(nd, app), cache["v"].select(nd, app),
                    pos, seq_sharded=seq_sharded))
            app += 1

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cache is None:
        return x, None
    mamba = {k: torch.stack([s[k] for s in new_mamba], dim=nd)
             for k in cache["mamba"]}
    return x, {"mamba": mamba, "k": cache["k"], "v": cache["v"],
               "pos": pos + T}


def zamba_loss(params, batch, cfg: ModelConfig, ctx: ParallelCtx):
    """Next-token cross-entropy: each rank's mean loss over its batch
    shard, f32 ``(*mesh,)`` (replicated over the TP group)."""
    h, _ = zamba_forward(params, batch["tokens"], cfg, ctx)
    tokens = batch["tokens"]
    return ce_loss(h[..., :-1, :], params["lm_head"], tokens[..., 1:], cfg,
                   ctx)


def zamba_init_state(cfg: ModelConfig, ctx: ParallelCtx, B_loc: int, S: int,
                     *, seq_sharded: bool = False, dtype=torch.bfloat16,
                     device=None):
    """A zeroed decode cache on the active context's mesh (the layout of
    :func:`zamba_forward`), one scalar position a rank; ``seq_sharded``
    keeps ``S / fsdp`` K/V rows a rank."""
    dctx = default_context()
    mesh = dctx.require_mesh()
    device = dctx.device if device is None else device
    din_loc = 2 * cfg.d_model // ctx.tp
    nh_loc = din_loc // MAMBA_HEAD_DIM
    L = cfg.num_layers
    n_app = L // max(cfg.attn_every, 1)
    S_loc = S // ctx.fsdp if seq_sharded else S
    kv = (*mesh.sizes, n_app, B_loc, S_loc, local_kv_heads(cfg, ctx),
          cfg.head_dim)
    return {
        "mamba": {
            "conv": torch.zeros(*mesh.sizes, L, B_loc, cfg.conv_width - 1,
                                din_loc, dtype=dtype, device=device),
            "S": torch.zeros(*mesh.sizes, L, B_loc, nh_loc, MAMBA_HEAD_DIM,
                             cfg.ssm_state, dtype=torch.float32,
                             device=device),
        },
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.zeros(mesh.sizes, dtype=torch.int32, device=device),
    }


def zamba_decode(params, tokens, cfg, ctx, cache, *, seq_sharded=False):
    """One decode step ``(*mesh, B, 1)`` -> (local logits, new cache)."""
    h, cache = zamba_forward(params, tokens, cfg, ctx, cache,
                             seq_sharded=seq_sharded)
    return dot_f32(h, params["lm_head"]), cache
