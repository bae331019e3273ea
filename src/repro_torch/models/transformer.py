"""Transformer forward passes on stacked ranks (dense, GQA MoE and VLM
families).

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

Caches are dicts of stacked tensors, ``{"k": (*mesh, L, B, S, KH_loc, D),
"v": ..., "pos": (*mesh,) or (*mesh, B)}``; the layers write K/V rows into
them in place.  MLA and MTP (deepseek-v3), the audio family and the
training loss are still to port (ROADMAP queue 1, items 9 and 10).
A MoE layer's dispatch stats add up over the layer loop in the active
``dispatch_stats`` frame, as the reference sums them over its scan.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.context import default_context, recorded_once
from .config import ModelConfig, ParallelCtx
from .layers import (KVCache, attention_block, dot_f32, embed_lookup,
                     local_kv_heads, mlp_block, moe_block, rmsnorm)

__all__ = ["init_cache", "transformer_forward", "transformer_prefill",
           "transformer_chunk_prefill", "transformer_decode"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm") \
            or cfg.moe != (cfg.family == "moe") \
            or cfg.attention != "gqa" or cfg.first_k_dense or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: only the dense, MoE and VLM families with GQA "
            f"attention are ported (MLA, its leading dense layers and MTP for "
            f"deepseek-v3, and the audio family: ROADMAP queue 1, item 9)")


def _layer(params: Dict[str, torch.Tensor], prefix: str, nd: int,
           l: int) -> Dict[str, torch.Tensor]:
    """Views of layer ``l`` of every ``prefix/…`` stacked param."""
    plen = len(prefix) + 1
    return {k[plen:]: v.select(nd, l) for k, v in params.items()
            if k.startswith(prefix + "/")}


def _layer_body(x, lp, cfg: ModelConfig, ctx: ParallelCtx, *, positions,
                prefix_len: int, cache=None, chunked: bool = False):
    """One decoder block: (attn + residual) then (ffn + residual)."""
    vlm = cfg.family == "vlm"
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plus_one=vlm)
    attn, new_cache = attention_block(
        h, lp, cfg, ctx, positions=positions, prefix_len=prefix_len,
        cache=cache, causal=cfg.causal, chunked=chunked)
    x = x + attn
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plus_one=vlm)
    if cfg.moe:
        return x + moe_block(h, lp, cfg, ctx), new_cache
    return x + mlp_block(h, lp, ctx, act="gelu" if vlm else "silu"), \
        new_cache


def _lm_head(params: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The LM head ``(*mesh, d, V_loc)``: the VLM's is the transposed
    embedding table (tied embeddings)."""
    if cfg.family == "vlm":
        return params["embed/table"].transpose(-1, -2)
    return params["lm_head"]


def init_cache(cfg: ModelConfig, ctx: ParallelCtx, B_loc: int, S: int, *,
               seq_sharded: bool = False, dtype=torch.bfloat16, device=None):
    """A zeroed decode cache on the active context's mesh: per rank
    ``(L, B_loc, S, KH_loc, D)`` K and V, and one position a rank."""
    _check_family(cfg)
    if seq_sharded:
        raise NotImplementedError(
            "the context(seq)-sharded cache is not ported yet: ROADMAP "
            "queue 1, item 9")
    dctx = default_context()
    mesh = dctx.require_mesh()
    device = dctx.device if device is None else device
    shape = (*mesh.sizes, cfg.num_layers, B_loc, S, local_kv_heads(cfg, ctx),
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(mesh.sizes, dtype=torch.int32, device=device)}


def transformer_forward(params: Dict[str, torch.Tensor], tokens,
                        cfg: ModelConfig, ctx: ParallelCtx, *,
                        prefix_embeds=None, embeds=None,
                        cache: Optional[dict] = None, positions=None,
                        seq_sharded: bool = False, chunked: bool = False):
    """tokens ``(*mesh, B, T)`` -> (hidden ``(*mesh, B, P + T, d)``,
    cache'); ``prefix_embeds (*mesh, B, P, d)`` go in front of the tokens
    (the VLM's image patches) under a bidirectional prefix window."""
    _check_family(cfg)
    if embeds is not None:
        raise NotImplementedError(
            "direct embeddings (the audio family) are not ported yet: "
            "ROADMAP queue 1, item 9")
    if seq_sharded:
        raise NotImplementedError(
            "the context(seq)-sharded cache is not ported yet: ROADMAP "
            "queue 1, item 9")
    nd = default_context().require_mesh().ndim
    x = embed_lookup(tokens, params["embed/table"], cfg, ctx)
    if cfg.family == "vlm":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    prefix_len = 0
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=nd + 1)
        prefix_len = prefix_embeds.shape[nd + 1]
    if positions is None:
        positions = torch.arange(x.shape[nd + 1], device=x.device)
    pos = cache["pos"] if cache is not None else None
    for l in range(cfg.num_layers):
        layer_cache = None if cache is None else KVCache(
            cache["k"].select(nd, l), cache["v"].select(nd, l), pos)
        with recorded_once(l == 0):
            x, new = _layer_body(x, _layer(params, "layers", nd, l), cfg,
                                 ctx, positions=positions,
                                 prefix_len=prefix_len, cache=layer_cache,
                                 chunked=chunked)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps,
                plus_one=cfg.family == "vlm")
    if cache is None:
        return x, None
    return x, {"k": cache["k"], "v": cache["v"], "pos": new.pos}


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
