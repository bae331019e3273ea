"""Serve-step factories: prefill, chunk-prefill and decode steps (dense, MoE
and VLM families; prefill and decode for the recurrent RWKV6 and hybrid
Zamba2 families, which the serving engine refuses, as in the reference).
``seq_sharded=True`` lays the K/V caches out context-sharded over "data"
(the long-context decode).  The audio encoder has no step here: its
forward is ``transformer_forward(params, None, cfg, ctx, embeds=...)``
under an inference context.

The reference wraps each step in ``shard_map`` plus ``jit``; here a built
step is a plain callable over stacked tensors, carrying the per-dim specs
of its tokens, cache and logits so a caller can lay global arrays out for
it (:func:`repro_torch.interop.stack_shards`) and read results back.  The
reference traces a jitted step once per input shape and logs its verbs
then; a built step logs its verbs on the first call for each input
signature and replays later calls against the scratch context.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..core.context import recorded_once
from ..kernels.plan import (resolve_dispatch_impl, resolve_ring_impl,
                            resolve_seq_parallel)
from ..launch.mesh import RankMesh
from ..models import api as model_api
from ..models import schema as sch
from ..models.config import ModelConfig, ParallelCtx
from ..models.layers import dot_f32
from ..models.rwkv import rwkv_forward
from ..models.ssm import zamba_forward
from ..models.transformer import (transformer_chunk_prefill,
                                  transformer_prefill)

__all__ = ["ServeStep", "build_decode_step", "build_prefill_step",
           "build_chunk_prefill_step"]


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__       # scalars are traced values, not shapes


@dataclasses.dataclass
class ServeStep:
    """A built step and the specs of what it takes and returns."""

    fn: Callable
    token_spec: tuple
    cache_specs: Dict[str, tuple]
    logits_spec: tuple

    def __post_init__(self):
        self._seen: set = set()

    def __call__(self, *args):
        sig = _signature(args)
        first = sig not in self._seen
        self._seen.add(sig)
        with recorded_once(first):
            return self.fn(*args)


def _serve_ctx(ctx: ParallelCtx) -> ParallelCtx:
    return dataclasses.replace(
        ctx, inference=True, remat=False,
        ring_impl=resolve_ring_impl(ctx.ring_impl),
        dispatch_impl=resolve_dispatch_impl(ctx.dispatch_impl),
        seq_parallel=resolve_seq_parallel(ctx.seq_parallel))


def _vocab_spec(cfg: ModelConfig) -> Optional[str]:
    return "model" if sch.vocab_sharded(cfg) else None


def _refuse_encoder(cfg: ModelConfig, what: str) -> None:
    if not model_api.has_decode(cfg):
        raise ValueError(
            f"{cfg.name} is an encoder ({cfg.family!r} family): it has no "
            f"{what} step; its forward is transformer_forward(params, None, "
            f"cfg, ctx, embeds=...) under an inference context")


def build_decode_step(cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx, *,
                      B: int, S: int, seq_sharded: bool = False,
                      slot_pos: bool = False) -> ServeStep:
    """(params, tokens (*mesh, B_loc, 1), cache) -> (logits, cache').

    ``slot_pos=True`` (the serving engine) lays ``cache["pos"]`` out as a
    per-slot (B,) vector sharded like the batch.
    """
    _refuse_encoder(cfg, "decode")
    ctx = _serve_ctx(ctx)
    decode = model_api.decode_fn(cfg)
    _, cspecs = model_api.cache_structs(cfg, mesh, ctx, B, S,
                                        seq_sharded=seq_sharded)
    bpart = model_api._batch_axes(mesh, B) or None
    if slot_pos:
        cspecs = dict(cspecs, pos=(bpart,))

    def step(params, tokens, cache):
        return decode(params, tokens, cfg, ctx, cache,
                      seq_sharded=seq_sharded)

    return ServeStep(step, (bpart, None), cspecs,
                     (bpart, None, _vocab_spec(cfg)))


def build_chunk_prefill_step(cfg: ModelConfig, mesh: RankMesh,
                             ctx: ParallelCtx, *, C: int, S_cache: int,
                             B: int = 1) -> ServeStep:
    """(params, tokens (*mesh, B, C), cache, rlen) -> (logits, cache').

    The engine's chunked-prefill unit: ``cache`` is one slot of the engine
    cache (B = 1, replicated over the batch axes) with one position a rank;
    the chunk goes in at that position and the logits of its last real
    token (``rlen - 1``) come back.  ``C`` is the chunk width the engine
    feeds.
    """
    if cfg.family not in model_api.TRANSFORMER_FAMILIES:
        raise ValueError(f"chunked prefill supports transformer families "
                         f"only, got {cfg.family!r}")
    _refuse_encoder(cfg, "chunked-prefill")
    del C                           # the shape comes with the tokens
    ctx = _serve_ctx(ctx)
    _, cspecs = model_api.cache_structs(cfg, mesh, ctx, B, S_cache)

    def step(params, tokens, cache, rlen):
        return transformer_chunk_prefill(params, tokens, cfg, ctx, cache,
                                         rlen)

    return ServeStep(step, (None, None), cspecs,
                     (None, None, _vocab_spec(cfg)))


def build_prefill_step(cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx, *,
                       B: int, S_cache: int,
                       seq_sharded: bool = False) -> ServeStep:
    """(params, tokens (*mesh, B_loc, Sp), cache) -> (last logits, cache').

    Transformer families fill a KV cache; the recurrent families run their
    stack over the prompt from the cache's state (zeros for a fresh one)
    and return the last position's logits with the new state."""
    _refuse_encoder(cfg, "prefill")
    ctx = _serve_ctx(ctx)
    _, cspecs = model_api.cache_structs(cfg, mesh, ctx, B, S_cache,
                                        seq_sharded=seq_sharded)
    bpart = model_api._batch_axes(mesh, B) or None

    if cfg.family in model_api.TRANSFORMER_FAMILIES:
        def step(params, tokens, cache):
            return transformer_prefill(params, tokens, cfg, ctx, cache,
                                       seq_sharded=seq_sharded)
    elif cfg.family == "ssm":
        def step(params, tokens, cache):
            h, cache = rwkv_forward(params, tokens, cfg, ctx, cache)
            return dot_f32(h[..., -1:, :], params["lm_head"]), cache
    elif cfg.family == "hybrid":
        def step(params, tokens, cache):
            h, cache = zamba_forward(params, tokens, cfg, ctx, cache,
                                     seq_sharded=seq_sharded)
            return dot_f32(h[..., -1:, :], params["lm_head"]), cache
    else:
        raise ValueError(cfg.family)

    return ServeStep(step, (bpart, None), cspecs,
                     (bpart, None, _vocab_spec(cfg)))
