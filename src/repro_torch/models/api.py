"""Family-dispatch API: the surface the serving and training layers talk
to (dense, GQA and MLA MoE, VLM, audio-encoder, RWKV6 and Zamba2
families).  The training losses of the dense, MoE (GQA), VLM, audio,
RWKV6 and Zamba2 families are ported; deepseek-v3's MTP loss waits for
ROADMAP queue 1, item 21.  The audio encoder has no decode step
(:func:`has_decode`).

``cache_structs`` gives the global view of a decode cache — each leaf's
global shape and dtype — with its per-dim spec, from which a stacked cache
is laid out (:func:`repro_torch.interop.local_shape`); ``seq_sharded``
puts ``"data"`` on the K/V caches' S dim (the context-parallel decode).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..launch.mesh import RankMesh
from . import schema as sch
from .config import ModelConfig, ParallelCtx
from .layers import local_kv_heads
from .rwkv import rwkv_decode, rwkv_loss
from .ssm import MAMBA_HEAD_DIM, zamba_decode, zamba_loss
from .transformer import layer_stacks, transformer_decode, transformer_loss

__all__ = ["TRANSFORMER_FAMILIES", "TensorStruct", "loss_fn", "decode_fn",
           "has_decode", "supports_long_context", "batch_structs",
           "cache_structs"]

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


class TensorStruct(NamedTuple):
    """A global shape and dtype (the counterpart of ShapeDtypeStruct)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def loss_fn(cfg: ModelConfig) -> Callable:
    """(params, batch, cfg, ctx) -> each rank's loss ``(*mesh,)``."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer_loss
    if cfg.family == "ssm":
        return rwkv_loss
    if cfg.family == "hybrid":
        return zamba_loss
    raise ValueError(cfg.family)


def decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens, cfg, ctx, cache, *, seq_sharded) -> (logits, cache)."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return lambda p, t, cfg, ctx, cache, seq_sharded=False: (
            transformer_decode(p, t, cfg, ctx, cache, seq_sharded=seq_sharded))
    if cfg.family == "ssm":
        return lambda p, t, cfg, ctx, cache, seq_sharded=False: (
            rwkv_decode(p, t, cfg, ctx, cache))
    if cfg.family == "hybrid":
        return lambda p, t, cfg, ctx, cache, seq_sharded=False: (
            zamba_decode(p, t, cfg, ctx, cache, seq_sharded=seq_sharded))
    raise ValueError(cfg.family)


def has_decode(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"  # encoder-only archs have no decode step


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic decode-state archs."""
    return cfg.family in ("ssm", "hybrid")


def _batch_axes(mesh: RankMesh, B: int,
                dp_axes: Tuple[str, ...] = ("pod", "data")) -> Tuple[str, ...]:
    axes = tuple(a for a in dp_axes if a in mesh.shape)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes if (axes and B % n == 0) else ()


def batch_structs(cfg: ModelConfig, mesh: RankMesh, B: int, S: int,
                  dtype=torch.bfloat16, dp_axes=("pod", "data")):
    """One train batch's global view: ``({leaf: TensorStruct}, {leaf:
    spec})``, the batch dim split over the DP axes where they divide it
    (replicated otherwise), as the reference lays it out."""
    ba = _batch_axes(mesh, B, dp_axes)
    bspec = ba if ba else None
    if cfg.family == "audio":
        structs = {
            "embeds": TensorStruct((B, S, cfg.d_model), dtype),
            "targets": TensorStruct((B, S), torch.int32),
            "mask": TensorStruct((B, S), torch.float32),
        }
        specs = {"embeds": (bspec, None, None), "targets": (bspec, None),
                 "mask": (bspec, None)}
    elif cfg.family == "vlm":
        P = cfg.prefix_tokens
        structs = {
            "tokens": TensorStruct((B, S - P), torch.int32),
            "prefix_embeds": TensorStruct((B, P, cfg.d_model), dtype),
        }
        specs = {"tokens": (bspec, None),
                 "prefix_embeds": (bspec, None, None)}
    else:
        structs = {"tokens": TensorStruct((B, S), torch.int32)}
        specs = {"tokens": (bspec, None)}
    return structs, specs


def cache_structs(cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx, B: int,
                  S: int, *, seq_sharded: bool = False,
                  dtype=torch.bfloat16):
    """Global-view decode cache: ``({leaf: TensorStruct}, {leaf: spec})``
    (the hybrid's Mamba states nest under ``"mamba"``).

    For head-parallel archs with replicated KV weights the cache's global
    KV dim is ``local_kv_heads · tp`` (each rank holds its q-block's kv
    group), as in the reference.  The recurrent families' layouts are the
    reference's: RWKV's token-shift carries and f32 WKV state, Zamba's conv
    and f32 SSM states, one KV cache per shared-block application and one
    scalar position.  MLA's latent cache (``c``, ``kr`` and the leading
    dense layers' ``dense_c``, ``dense_kr``) is replicated over "model",
    and whole over "data" whatever ``seq_sharded`` says, as in the
    reference.  The audio encoder's entry is the dense layout, as the
    reference's is, though it has no decode step.
    """
    ba = _batch_axes(mesh, B)
    bspec = ba if ba else None
    sspec = "data" if seq_sharded else None
    if cfg.family == "ssm":
        d, hd, L = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
        carry = TensorStruct((L, B, d), dtype)
        return ({"x_tm": carry, "x_cm": carry,
                 "S": TensorStruct((L, B, d // hd, hd, hd), torch.float32)},
                {"x_tm": (None, bspec, None), "x_cm": (None, bspec, None),
                 "S": (None, bspec, "model", None, None)})
    if cfg.family == "hybrid":
        din, L = 2 * cfg.d_model, cfg.num_layers
        n_app = L // max(cfg.attn_every, 1)
        kv = TensorStruct((n_app, B, S, cfg.kv_heads, cfg.head_dim), dtype)
        kspec = (None, bspec, sspec,
                 "model" if sch.kv_sharded(cfg) else None, None)
        return ({"mamba": {
                    "conv": TensorStruct((L, B, cfg.conv_width - 1, din),
                                         dtype),
                    "S": TensorStruct((L, B, din // MAMBA_HEAD_DIM,
                                       MAMBA_HEAD_DIM, cfg.ssm_state),
                                      torch.float32)},
                 "k": kv, "v": kv, "pos": TensorStruct((), torch.int32)},
                {"mamba": {"conv": (None, bspec, None, "model"),
                           "S": (None, bspec, "model", None, None)},
                 "k": kspec, "v": kspec, "pos": ()})
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(cfg.family)
    if cfg.attention == "mla":
        structs, specs = {}, {}
        for _, L, _, names in layer_stacks(cfg):
            for n, w in zip(names, (cfg.kv_lora_rank, cfg.qk_rope_head_dim)):
                structs[n] = TensorStruct((L, B, S, w), dtype)
                specs[n] = (None, bspec, None, None)
        structs["pos"], specs["pos"] = TensorStruct((), torch.int32), ()
        return structs, specs
    KH_loc = local_kv_heads(cfg, ctx)
    kv_model = sch.kv_sharded(cfg) or (sch.head_parallel(cfg) and ctx.tp > 1)
    KH_glob = KH_loc * ctx.tp if kv_model else cfg.kv_heads
    spec = (None, bspec, sspec, "model" if kv_model else None, None)
    kv = TensorStruct((cfg.num_layers, B, S, KH_glob, cfg.head_dim), dtype)
    return ({"k": kv, "v": kv, "pos": TensorStruct((), torch.int32)},
            {"k": spec, "v": spec, "pos": ()})
