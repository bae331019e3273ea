"""Family-dispatch API: the surface the serving layer talks to (dense and
GQA MoE families; MLA and the recurrent families are still to port, ROADMAP
queue 1, item 9).

``cache_structs`` gives the global view of a decode cache — each leaf's
global shape and dtype — with its per-dim spec, from which a stacked cache
is laid out (:func:`repro_torch.interop.local_shape`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..launch.mesh import RankMesh
from . import schema as sch
from .config import ModelConfig, ParallelCtx
from .layers import local_kv_heads
from .transformer import transformer_decode

__all__ = ["TRANSFORMER_FAMILIES", "TensorStruct", "decode_fn", "has_decode",
           "cache_structs"]

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


class TensorStruct(NamedTuple):
    """A global shape and dtype (the counterpart of ShapeDtypeStruct)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens, cfg, ctx, cache, *, seq_sharded) -> (logits, cache)."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return lambda p, t, cfg, ctx, cache, seq_sharded=False: (
            transformer_decode(p, t, cfg, ctx, cache, seq_sharded=seq_sharded))
    raise NotImplementedError(
        f"the {cfg.family!r} family's decode is not ported yet: ROADMAP "
        f"queue 1, item 9")


def has_decode(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"  # encoder-only archs have no decode step


def _batch_axes(mesh: RankMesh, B: int,
                dp_axes: Tuple[str, ...] = ("pod", "data")) -> Tuple[str, ...]:
    axes = tuple(a for a in dp_axes if a in mesh.shape)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes if (axes and B % n == 0) else ()


def cache_structs(cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx, B: int,
                  S: int, *, seq_sharded: bool = False,
                  dtype=torch.bfloat16):
    """Global-view decode cache: ``({leaf: TensorStruct}, {leaf: spec})``.

    For head-parallel archs with replicated KV weights the cache's global
    KV dim is ``local_kv_heads · tp`` (each rank holds its q-block's kv
    group), as in the reference.
    """
    if cfg.family not in TRANSFORMER_FAMILIES or cfg.attention != "gqa" \
            or cfg.first_k_dense:
        raise NotImplementedError(
            f"{cfg.name}: only the GQA cache (dense and MoE families) is "
            f"ported yet; MLA's latent cache and the other families: ROADMAP "
            f"queue 1, item 9")
    if seq_sharded:
        raise NotImplementedError(
            "the context(seq)-sharded cache is not ported yet: ROADMAP "
            "queue 1, item 9")
    ba = _batch_axes(mesh, B)
    bspec = ba if ba else None
    KH_loc = local_kv_heads(cfg, ctx)
    kv_model = sch.kv_sharded(cfg) or (sch.head_parallel(cfg) and ctx.tp > 1)
    KH_glob = KH_loc * ctx.tp if kv_model else cfg.kv_heads
    spec = (None, bspec, None, "model" if kv_model else None, None)
    kv = TensorStruct((cfg.num_layers, B, S, KH_glob, cfg.head_dim), dtype)
    return ({"k": kv, "v": kv, "pos": TensorStruct((), torch.int32)},
            {"k": spec, "v": spec, "pos": ()})
