"""Transformer forward passes on stacked ranks (dense, GQA and MLA MoE, VLM
and audio-encoder families).

The reference scans its layer stack (``lax.scan`` over the leading L dim of
every stacked param); the port runs a Python loop over per-layer views of
the same ``(*mesh, L, ...)`` tensors.  The reference traces the scan body
once, so its collectives are logged once per trace: the port's first layer
records against the active context and later layers against its scratch
context (:func:`~repro_torch.core.context.recorded_once`).

The VLM (paligemma) scales its embeddings by ``sqrt(d_model)``, normalizes
with ``1 + scale``, runs a GeGLU MLP and ties its head to the embedding
table; ``prefix_embeds`` (the image patches, a stub as in the reference)
go in front of the tokens under a bidirectional prefix window.

The audio encoder (hubert) takes frame embeddings directly (``embeds``),
normalizes them by ``embed_norm``, adds sinusoidal positions, attends
without a causal mask and runs a plain GELU MLP; its loss is the
masked-frame cross-entropy against ``head``.

DeepSeek-V3 (``attention="mla"``) runs its ``first_k_dense`` leading dense
layers (``dense_layers/*``) before the MoE stack, each stack from the same
starting position, as the reference runs two scans; its loss adds the
multi-token-prediction term (:func:`mtp_loss`, one more MLA layer over the
``mtp/*`` leaves).

Caches are dicts of stacked tensors, ``{"k": (*mesh, L, B, S, KH_loc, D),
"v": ..., "pos": (*mesh,) or (*mesh, B)}``, or MLA's latent cache ``{"c":
(*mesh, L, B, S, kv_lora_rank), "kr": (..., dr), "dense_c", "dense_kr",
"pos"}`` (the leading dense layers' pair apart); the layers write rows into
them in place.  A context(seq)-sharded cache (``seq_sharded=True``) keeps
``S / data`` K/V rows a rank; MLA's latent cache ignores the flag, as in
the reference.  Every family here trains; training checkpoints each
layer (``ctx.remat``), the MTP layer included.
A MoE layer's dispatch stats add up over the layer loop in the active
``dispatch_stats`` frame, as the reference sums them over its scan.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.context import default_context, recorded_once
from .config import ModelConfig, ParallelCtx
from .layers import (KVCache, MLACache, attention_block, ce_loss, dot,
                     dot_f32, embed_lookup, gather_fsdp, gelu_mlp_block,
                     layernorm, local_kv_heads, mla_block, mlp_block,
                     moe_block, rmsnorm)

__all__ = ["init_cache", "mtp_loss", "remat", "transformer_forward",
           "transformer_loss", "transformer_prefill",
           "transformer_chunk_prefill", "transformer_decode"]


def _check_family(cfg: ModelConfig) -> None:
    mla = cfg.attention == "mla"
    if cfg.family not in ("dense", "moe", "vlm", "audio") \
            or cfg.moe != (cfg.family == "moe") \
            or cfg.attention not in ("gqa", "mla") or (mla and not cfg.moe) \
            or ((cfg.first_k_dense or cfg.mtp) and not mla):
        raise ValueError(
            f"{cfg.name}: the transformer stack runs the dense, VLM and "
            f"audio families with GQA attention and the MoE family with GQA "
            f"or MLA attention (MLA with its leading dense layers and MTP "
            f"leaves)")


def _sinusoid(T: int, d: int, dtype, device) -> torch.Tensor:
    """The audio encoder's additive positions ``(T, d)``: sin on the even
    columns, cos on the odd, in f32, cast to ``dtype``."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros(T, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, :d // 2])
    return pe.to(dtype)


def layer_stacks(cfg: ModelConfig):
    """The layer stacks in order: (param prefix, depth, MoE FFN, the two
    cache leaves).  DeepSeek's leading dense layers come first."""
    kd = cfg.first_k_dense if cfg.moe else 0
    leaves = ("c", "kr") if cfg.attention == "mla" else ("k", "v")
    out = [("dense_layers", kd, False, ("dense_c", "dense_kr"))] if kd else []
    return out + [("layers", cfg.num_layers - kd, cfg.moe, leaves)]


def _layer(params: Dict[str, torch.Tensor], prefix: str, nd: int,
           l: int) -> Dict[str, torch.Tensor]:
    """Views of layer ``l`` of every ``prefix/…`` stacked param."""
    plen = len(prefix) + 1
    return {k[plen:]: v.select(nd, l) for k, v in params.items()
            if k.startswith(prefix + "/")}


def _layer_body(x, lp, cfg: ModelConfig, ctx: ParallelCtx, *, moe: bool,
                positions, prefix_len: int, cache=None,
                chunked: bool = False):
    """One decoder (or encoder) block: (attn + residual) then (ffn +
    residual); the FFN is the experts where ``moe`` (deepseek's shared
    experts sit inside ``moe_block``), the GELU MLP for the audio encoder,
    else the gated MLP."""
    vlm = cfg.family == "vlm"
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plus_one=vlm)
    if cfg.attention == "mla":
        attn, new_cache = mla_block(h, lp, cfg, ctx, positions=positions,
                                    cache=cache, chunked=chunked)
    else:
        attn, new_cache = attention_block(
            h, lp, cfg, ctx, positions=positions, prefix_len=prefix_len,
            cache=cache, causal=cfg.causal, chunked=chunked)
    x = x + attn
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plus_one=vlm)
    if moe:
        return x + moe_block(h, lp, cfg, ctx), new_cache
    if cfg.family == "audio":
        return x + gelu_mlp_block(h, lp, ctx), new_cache
    return x + mlp_block(h, lp, ctx, act="gelu" if vlm else "silu"), \
        new_cache


def remat(fn, x, first: bool):
    """``fn(x)`` for training under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed in the
    backward (the reference's ``jax.checkpoint``).  The reference traces
    the checkpointed function once, so only the first run logs, against
    the active context when ``first`` (else against its scratch context):
    the recompute runs the Python again, and logs against the scratch
    context.  The recompute runs in the backward (on the card, in the
    autograd engine's thread), so both runs name the context of the
    forward's caller."""
    runs = []
    parent = default_context()

    def body(h):
        with recorded_once(first and not runs, parent):
            runs.append(1)
            return fn(h)

    return checkpoint(body, x, use_reentrant=False)


def _remat_stack(x, params, prefix: str, L: int, moe: bool,
                 cfg: ModelConfig, ctx: ParallelCtx, positions,
                 prefix_len: int):
    """The ``L`` layers of the ``prefix/…`` stack over ``x`` for training,
    each checkpointed (:func:`remat`); the reference traces the stack's
    scan body once, so only the first layer logs."""
    nd = default_context().require_mesh().ndim
    for l in range(L):
        lp = _layer(params, prefix, nd, l)
        x = remat(lambda h, lp=lp: _layer_body(
            h, lp, cfg, ctx, moe=moe, positions=positions,
            prefix_len=prefix_len)[0], x, l == 0)
    return x


def _lm_head(params: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The LM head ``(*mesh, d, V_loc)``: the VLM's is the transposed
    embedding table (tied embeddings)."""
    if cfg.family == "vlm":
        return params["embed/table"].transpose(-1, -2)
    return params["lm_head"]


def init_cache(cfg: ModelConfig, ctx: ParallelCtx, B_loc: int, S: int, *,
               seq_sharded: bool = False, dtype=torch.bfloat16, device=None):
    """A zeroed decode cache on the active context's mesh: per rank
    ``(L, B_loc, S, KH_loc, D)`` K and V, or MLA's ``(L, B_loc, S,
    kv_lora_rank)`` latents and ``(L, B_loc, S, dr)`` rope'd keys (the
    leading dense layers' pair under ``dense_c`` / ``dense_kr``), and one
    position a rank.  ``seq_sharded`` keeps ``S / fsdp`` K/V rows a rank
    (the latent cache stays whole, as in the reference); it must be passed
    again, identically, to the forward."""
    _check_family(cfg)
    dctx = default_context()
    mesh = dctx.require_mesh()
    device = dctx.device if device is None else device
    if cfg.attention == "mla":       # a row: (c, kr)
        rows = ((cfg.kv_lora_rank,), (cfg.qk_rope_head_dim,))
    else:                            # a row: (k, v)
        rows = ((local_kv_heads(cfg, ctx), cfg.head_dim),) * 2
        if seq_sharded:
            S = S // ctx.fsdp
    cache = {}
    for _, L, _, names in layer_stacks(cfg):
        for name, row in zip(names, rows):
            cache[name] = torch.zeros((*mesh.sizes, L, B_loc, S, *row),
                                      dtype=dtype, device=device)
    cache["pos"] = torch.zeros(mesh.sizes, dtype=torch.int32, device=device)
    return cache


def transformer_forward(params: Dict[str, torch.Tensor], tokens,
                        cfg: ModelConfig, ctx: ParallelCtx, *,
                        prefix_embeds=None, embeds=None,
                        cache: Optional[dict] = None, positions=None,
                        seq_sharded: bool = False, chunked: bool = False):
    """tokens ``(*mesh, B, T)`` -> (hidden ``(*mesh, B, P + T, d)``,
    cache'); ``prefix_embeds (*mesh, B, P, d)`` go in front of the tokens
    (the VLM's image patches) under a bidirectional prefix window;
    ``embeds (*mesh, B, T, d)`` replace the token lookup (the audio
    encoder's frames).  ``seq_sharded`` marks a context-sharded cache (see
    :func:`init_cache`)."""
    _check_family(cfg)
    nd = default_context().require_mesh().ndim
    if embeds is not None:
        x = embeds
    else:
        x = embed_lookup(tokens, params["embed/table"], cfg, ctx)
        if cfg.family == "vlm":
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    prefix_len = 0
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=nd + 1)
        prefix_len = prefix_embeds.shape[nd + 1]
    if "embed_norm" in params:
        x = layernorm(x, params["embed_norm"], cfg.norm_eps)
    if cfg.family == "audio":
        x = x + _sinusoid(x.shape[nd + 1], cfg.d_model, x.dtype, x.device)
    if positions is None:
        positions = torch.arange(x.shape[nd + 1], device=x.device)
    pos = cache["pos"] if cache is not None else None
    checkpointed = ctx.remat and cache is None and torch.is_grad_enabled()
    Cache = MLACache if cfg.attention == "mla" else KVCache
    sharded = {} if Cache is MLACache else {"seq_sharded": seq_sharded}
    for prefix, L, moe, (ka, kb) in layer_stacks(cfg):
        if checkpointed:
            x = _remat_stack(x, params, prefix, L, moe, cfg, ctx, positions,
                             prefix_len)
            continue
        for l in range(L):
            lp = _layer(params, prefix, nd, l)
            layer_cache = None if cache is None else Cache(
                cache[ka].select(nd, l), cache[kb].select(nd, l), pos,
                **sharded)
            with recorded_once(l == 0):
                x, new = _layer_body(x, lp, cfg, ctx, moe=moe,
                                     positions=positions,
                                     prefix_len=prefix_len,
                                     cache=layer_cache, chunked=chunked)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps,
                plus_one=cfg.family == "vlm")
    if cache is None:
        return x, None
    return x, {**{n: t for n, t in cache.items() if n != "pos"},
               "pos": new.pos}


def transformer_loss(params, batch, cfg: ModelConfig, ctx: ParallelCtx):
    """Next-token cross-entropy of the dense, MoE and VLM families, or the
    audio encoder's masked-frame cross-entropy: each rank's mean loss over
    its batch shard, f32 ``(*mesh,)`` (replicated over the TP group).  The
    MoE family (qwen3-moe) is scored as the dense one, its expert layers'
    drop counts recorded into the active ``dispatch_stats`` frame; a config
    with multi-token prediction (deepseek-v3) adds 0.1 times
    :func:`mtp_loss`, whose layer is dense and records no drops.
    ``batch["tokens"] (*mesh, B, T)``; the VLM's ``batch["prefix_embeds"]
    (*mesh, B, P, d)`` go in front, and only the token positions are
    scored; the audio batch is ``embeds (*mesh, B, T, d)``, ``targets``
    and the frame ``mask`` (the loss's weights), scored against ``head``
    gathered whole over the data axis.  With ``ctx.remat`` and gradients
    on, each layer is checkpointed."""
    if cfg.family == "audio":
        h, _ = transformer_forward(params, None, cfg, ctx,
                                   embeds=batch["embeds"])
        head = gather_fsdp(params["head"], ctx, dim=0)       # (d, V) whole
        return ce_loss(h, head, batch["targets"], cfg, ctx,
                       weights=batch.get("mask"))
    nd = default_context().require_mesh().ndim
    prefix = batch.get("prefix_embeds")
    h, _ = transformer_forward(params, batch["tokens"], cfg, ctx,
                               prefix_embeds=prefix)
    if prefix is not None:
        h = h[..., prefix.shape[nd + 1]:, :]
    tokens = batch["tokens"]
    loss = ce_loss(h[..., :-1, :], _lm_head(params, cfg), tokens[..., 1:],
                   cfg, ctx)
    if cfg.mtp:
        loss = loss + 0.1 * mtp_loss(params, h, tokens, cfg, ctx)
    return loss


def mtp_loss(params, h, tokens, cfg: ModelConfig, ctx: ParallelCtx):
    """DeepSeek-V3's multi-token-prediction term (before its 0.1 weight):
    the final-normed hidden ``h (*mesh, B, T, d)`` at positions ``t < T - 1``
    and the embedding of token ``t + 1``, each normalized (``mtp/norm_h``,
    ``mtp/norm_e``), joined and projected by ``mtp/proj`` (gathered over
    FSDP on its input dim, accumulated in f32), run through the one MLA
    layer of ``mtp/layer`` (a dense MLP; positions from 0) and scored
    through the LM head against token ``t + 2``.  Each rank's mean, f32
    ``(*mesh,)``."""
    nd = default_context().require_mesh().ndim
    emb = embed_lookup(tokens[..., 1:], params["embed/table"], cfg, ctx)
    hm = rmsnorm(h[..., :-1, :], params["mtp/norm_h"], cfg.norm_eps)
    em = rmsnorm(emb, params["mtp/norm_e"], cfg.norm_eps)
    z = dot(torch.cat([hm, em], dim=-1),
            gather_fsdp(params["mtp/proj"], ctx, dim=0))
    positions = torch.arange(z.shape[nd + 1], device=z.device)
    if ctx.remat and torch.is_grad_enabled():
        z = _remat_stack(z, params, "mtp/layer", 1, False, cfg, ctx,
                         positions, 0)
    else:
        z = _layer_body(z, _layer(params, "mtp/layer", nd, 0), cfg, ctx,
                        moe=False, positions=positions, prefix_len=0)[0]
    return ce_loss(z[..., :-1, :], _lm_head(params, cfg), tokens[..., 2:],
                   cfg, ctx)


def transformer_prefill(params, tokens, cfg, ctx, cache, *,
                        prefix_embeds=None, seq_sharded: bool = False):
    """Fill the cache from a prompt; returns (last-position logits, cache)."""
    h, cache = transformer_forward(params, tokens, cfg, ctx, cache=cache,
                                   prefix_embeds=prefix_embeds,
                                   seq_sharded=seq_sharded)
    return dot_f32(h[..., -1:, :], _lm_head(params, cfg)), cache


def transformer_chunk_prefill(params, tokens, cfg, ctx, cache, rlen, *,
                              seq_sharded: bool = False):
    """One chunked-prefill step: append ``tokens (*mesh, B, C)`` at
    ``cache['pos']``.  ``rlen`` (an int or one per rank, 1 <= rlen <= C)
    counts the chunk's real tokens; the tail is padding that the causal mask
    hides and the next write overwrites.  Returns the logits at the last
    real position and the cache with ``pos`` advanced by ``rlen``."""
    if seq_sharded:
        raise ValueError("chunked prefill does not support seq_sharded caches")
    nd = default_context().require_mesh().ndim
    C = tokens.shape[-1]
    p0 = cache["pos"]
    positions = p0.reshape(*p0.shape, 1, 1) + torch.arange(C, device=p0.device)
    h, cache = transformer_forward(params, tokens, cfg, ctx, cache=cache,
                                   positions=positions, chunked=True)
    rlen = torch.as_tensor(rlen, device=h.device).expand(p0.shape)
    idx = (rlen - 1).clamp(min=0).reshape(*p0.shape, 1, 1, 1)
    last = torch.gather(h, nd + 1, idx.expand(*h.shape[:nd + 1], 1,
                                              h.shape[-1]))
    logits = dot_f32(last, _lm_head(params, cfg))
    # the layers advanced pos by the full (possibly padded) chunk width;
    # the true advance is the real token count
    cache["pos"] = p0 + rlen.to(p0.dtype)
    return logits, cache


def transformer_decode(params, tokens, cfg, ctx, cache, *,
                       seq_sharded: bool = False):
    """One decode step: tokens ``(*mesh, B, 1)`` -> (local logits
    ``(*mesh, B, 1, V/tp)``, cache).  ``cache["pos"]`` is one position a
    rank or one a slot (continuous batching)."""
    nd = default_context().require_mesh().ndim
    pos = cache["pos"]
    positions = pos[..., None] if pos.dim() > nd else pos.reshape(
        *pos.shape, 1, 1)
    h, cache = transformer_forward(params, tokens, cfg, ctx, cache=cache,
                                   positions=positions,
                                   seq_sharded=seq_sharded)
    return dot_f32(h, _lm_head(params, cfg)), cache
