"""Manual-SPMD layer library on stacked ranks (dense, GQA MoE, VLM, RWKV6
and Zamba2 families).

The reference runs every function here inside ``shard_map`` on one rank's
shard; the port runs it once on stacked tensors whose leading dims are the
mesh axes of the active :class:`~repro_torch.core.context.DiompContext`,
and issues every cross-rank movement through its OMPCCL verbs.  Layouts
follow the reference (per rank):

* activations ``(B_loc, T, d)``; weights TP-sharded over "model" (column /
  row Megatron style), ZeRO-3-sharded over "data" and gathered at use;
* attention head-parallel when the heads divide ``MAX_TP``, else
  token-parallel (all-gathered K/V or the fused ring); decode caches
  head-sharded or replicated per the same rules.

Not ported here: the context-parallel decode (``cp_decode_attention``) and
its seq-sharded cache, MLA, MoE's ``expert2d`` placement,
``ring_fsdp_matmul`` and the int8 weight gather; each raises
``NotImplementedError`` naming its ROADMAP item where it would be reached.

The decode and chunk-prefill branches write the new K/V rows into the
cache in place (the reference returns an updated copy): a step's cache is
the engine's own tensor, so no second copy of it is ever held.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import ompccl
from ..core.backends import XlaBackend, group_rank
from ..core.context import default_context
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.moe_dispatch.fused import expert_slots, kept_counts, scatter_rows
from ..kernels.moe_dispatch.kernel import expert_mlp
from ..kernels.moe_dispatch.ops import moe_dispatch
from ..kernels.moe_dispatch.ref import route_topk
from ..kernels.plan import resolve_dispatch_impl, resolve_seq_parallel
from .config import ModelConfig, ParallelCtx
from .schema import head_parallel, kv_sharded, vocab_sharded

__all__ = [
    "rmsnorm", "layernorm", "rope", "gather_fsdp", "tp_allreduce",
    "col_matmul", "row_matmul", "embed_lookup", "KVCache", "local_kv_heads",
    "attention_block", "mlp_block", "moe_capacity", "moe_block", "dot",
    "flat_heads",
]


def _mesh():
    return default_context().require_mesh()


def _lift(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stacked per-rank ``w (*mesh, *s)`` viewed to broadcast against a
    stacked ``x (*mesh, ..., *s)``."""
    nd = _mesh().ndim
    extra = x.dim() - w.dim()
    return w.reshape(*w.shape[:nd], *([1] * extra), *w.shape[nd:])


def _rank_index(group, ndim: int, device) -> torch.Tensor:
    """Every rank's index within ``group``, shaped ``(*mesh, 1, ...)`` to
    broadcast against a stacked tensor of ``ndim`` dims (``axis_index``)."""
    mesh = _mesh()
    r = group_rank(group, mesh, device)
    return r.reshape(*mesh.sizes, *([1] * (ndim - mesh.ndim)))


def flat_heads(t: torch.Tensor) -> torch.Tensor:
    """``(*mesh, B, T, H, k)`` -> ``(ranks·B·H, T, k)``, contiguous: the
    batch of sequences a linear scan takes."""
    T, k = t.shape[-3], t.shape[-1]
    return t.transpose(-3, -2).reshape(-1, T, k).contiguous()


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32).astype(x.dtype)`` per
    rank: ``x (*mesh, ..., k)`` @ ``w (*mesh, k, n)`` as one batched matmul
    over the ranks (f32 accumulation; a mixed pair promotes first)."""
    nd = _mesh().ndim
    dt = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(*x.shape[:nd], -1, x.shape[-1])
    y = torch.matmul(x2.to(dt), w.to(dt))
    return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x.astype(f32), w.astype(f32))`` per rank (the LM head)."""
    return dot(x.float(), w.float())


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-5, plus_one: bool = False):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    s = _lift(scale, x).float()
    if plus_one:
        s = 1.0 + s
    return (xf * inv * s).to(x.dtype)


def layernorm(x, scale_bias, eps: float = 1e-5):
    """scale_bias ``(*mesh, 2, d)``: row 0 scale, row 1 bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    scale = _lift(scale_bias.select(-2, 0), x).float()
    bias = _lift(scale_bias.select(-2, 1), x).float()
    return (y * scale + bias).to(x.dtype)


def rope(x, positions, *, theta: float = 10_000.0, fraction: float = 1.0):
    """x ``(..., T, H, D)``; positions ``(T,)`` or any ``(..., T)`` that
    broadcasts against x's leading dims (per-rank, per-slot offsets)."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(x.device, torch.float32)[..., None] * freqs
    cos = torch.cos(ang).unsqueeze(-2)                  # (..., T, 1, half)
    sin = torch.sin(ang).unsqueeze(-2)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# communication helpers (all traffic through OMPCCL)
# ---------------------------------------------------------------------------

def gather_fsdp(w, ctx: ParallelCtx, dim: int = 0):
    """ZeRO-3 weight all-gather over the data axis (no-op if fsdp == 1 or
    the weights arrive whole); ``dim`` is the per-rank axis."""
    if ctx.fsdp <= 1 or not ctx.fsdp_params:
        return w
    if ctx.gather_codec == "int8":
        raise NotImplementedError(
            "the int8 weight gather is not ported yet: ROADMAP queue 1, "
            "item 8")
    return ompccl.allgather(w, ctx.fsdp_group, axis=dim,
                            invariant=ctx.inference)


def tp_allreduce(x, ctx: ParallelCtx):
    if ctx.tp <= 1:
        return x
    return ompccl.allreduce(x, ctx.tp_group)


def col_matmul(x, w_local, ctx: ParallelCtx, bias_local=None):
    """Megatron column-parallel: x (…, d) × W (d/fsdp, out/tp) -> (…, out/tp)."""
    if ctx.use_ring_matmul:
        raise NotImplementedError(
            "ring_fsdp_matmul (use_ring_matmul) is not ported yet: ROADMAP "
            "queue 1, item 9")
    y = dot(x, gather_fsdp(w_local, ctx, dim=0))
    if bias_local is not None:
        y = y + _lift(bias_local, y).to(y.dtype)
    return y


def row_matmul(x, w_local, ctx: ParallelCtx):
    """Megatron row-parallel: x (…, in/tp) × W (in/tp, d/fsdp) -> allreduced."""
    return tp_allreduce(dot(x, gather_fsdp(w_local, ctx, dim=1)), ctx)


# ---------------------------------------------------------------------------
# embedding (vocab-sharded over the TP group)
# ---------------------------------------------------------------------------

def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank ``table[idx]``: table ``(*mesh, V, d)``, idx ``(*mesh, ...)``."""
    mesh = _mesh()
    R = mesh.size
    t = table.reshape(R, *table.shape[mesh.ndim:])
    i = idx.reshape(R, -1)
    rows = torch.arange(R, device=t.device)[:, None]
    return t[rows, i].reshape(*idx.shape, *t.shape[2:])


def embed_lookup(tokens, table_local, cfg: ModelConfig, ctx: ParallelCtx):
    """tokens ``(*mesh, B, T)`` int; table_local ``(*mesh, V/tp, d)``."""
    if not vocab_sharded(cfg) or ctx.tp <= 1:
        return _take_rows(table_local, tokens)
    vloc = table_local.shape[-2]
    off = _rank_index(ctx.tp_group, tokens.dim(), tokens.device) * vloc
    local = tokens - off
    hit = (local >= 0) & (local < vloc)
    e = _take_rows(table_local, local.clamp(0, vloc - 1))
    e = torch.where(hit[..., None], e, torch.zeros_like(e))
    return tp_allreduce(e, ctx)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """One layer's decode cache on stacked ranks: ``k``/``v`` are
    ``(*mesh, B, S, KH_loc, D)`` (views of the stacked cache), ``pos`` is
    ``(*mesh,)`` (one position a rank) or ``(*mesh, B)`` (per slot)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    seq_sharded: bool = False


def _per_row(pos: torch.Tensor) -> torch.Tensor:
    """A cache position as ``(*mesh, B|1)`` per-row offsets."""
    return pos if pos.dim() > _mesh().ndim else pos[..., None]


def _write_rows(dst: torch.Tensor, src: torch.Tensor,
                start: torch.Tensor) -> None:
    """In place: ``dst[..., b, start + t] = src[..., b, t]`` for every rank
    and batch row; dst ``(*mesh, B, S, ...)``, src ``(*mesh, B, T, ...)``,
    start broadcasting to ``(*mesh, B)``.  The start clamps to ``S - T``,
    as ``lax.dynamic_update_slice`` does."""
    nd = _mesh().ndim
    lead = dst.shape[:nd + 1]
    S, T = dst.shape[nd + 1], src.shape[nd + 1]
    dev = dst.device
    start = _per_row(start).to(dev).expand(lead).clamp(0, S - T)
    rows = start[..., None] + torch.arange(T, device=dev)
    idx = [torch.arange(n, device=dev).reshape(
        [n if i == j else 1 for i in range(nd + 2)])
        for j, n in enumerate(lead)]
    dst.index_put_((*idx, rows), src.to(dst.dtype))


def _update_cache(cache: KVCache, k_new, v_new) -> KVCache:
    """Write one decode step's K/V at ``cache.pos`` (scalar or per slot)."""
    if cache.seq_sharded:
        raise NotImplementedError(
            "the context(seq)-sharded decode cache (cp_decode_attention) is "
            "not ported yet: ROADMAP queue 1, item 9")
    _write_rows(cache.k, k_new, cache.pos)
    _write_rows(cache.v, v_new, cache.pos)
    return KVCache(cache.k, cache.v, cache.pos + 1)


def local_kv_heads(cfg: ModelConfig, ctx: ParallelCtx) -> int:
    """KV heads each rank keeps (cache + attention operand width)."""
    if kv_sharded(cfg):
        return cfg.kv_heads // ctx.tp
    if head_parallel(cfg) and ctx.tp > 1:
        H_loc = cfg.num_heads // ctx.tp
        group = cfg.num_heads // cfg.kv_heads
        assert H_loc % group == 0 or group % H_loc == 0, (H_loc, group)
        return max(1, H_loc // group)
    return cfg.kv_heads


def _slice_kv(kv, cfg: ModelConfig, ctx: ParallelCtx):
    """With heads sharded but KV replicated, keep only the KV heads each
    rank's q-head block maps to (q head h -> kv head h // (H/KV))."""
    keep = local_kv_heads(cfg, ctx)
    if keep == kv.shape[-2]:
        return kv
    H_loc = cfg.num_heads // ctx.tp
    group = cfg.num_heads // cfg.kv_heads
    first = _rank_index(ctx.tp_group, kv.dim(), kv.device) * H_loc // group
    idx = first + torch.arange(keep, device=kv.device).reshape(keep, 1)
    return torch.gather(kv, -2, idx.expand(*kv.shape[:-2], keep,
                                           kv.shape[-1]))


def _my_chunk(x: torch.Tensor, group, dim: int, size: int) -> torch.Tensor:
    """Per rank, the ``size`` rows of per-rank dim ``dim`` that start at
    its group rank times ``size`` (``lax.dynamic_slice_in_dim`` at
    ``axis_index · size``); a copy of those rows only."""
    mesh = _mesh()
    nd = mesh.ndim
    d = nd + dim
    lead = torch.meshgrid(*[torch.arange(n, device=x.device)
                            for n in mesh.sizes], indexing="ij")
    me = group_rank(group, mesh, x.device)
    chunks = x.unflatten(d, (x.shape[d] // size, size)).movedim(d, nd)
    return chunks[(*lead, me)]


def attention_block(x, lp: Dict[str, torch.Tensor], cfg: ModelConfig,
                    ctx: ParallelCtx, *, positions=None, prefix_len: int = 0,
                    cache: Optional[KVCache] = None,
                    causal: Optional[bool] = None, chunked: bool = False):
    """GQA attention on the residual input x ``(*mesh, B, T, d)``; returns
    ``(out, cache')``.  The reference's strategies:

    * head-parallel — q heads divide ``MAX_TP``: heads sharded over "model";
    * token-parallel — otherwise (paligemma's 8 heads): weights replicated
      over "model", the T axis sliced; K/V all-gathered over the group, or
      under ``seq_parallel="ring"`` (no cache, no prefix) rotated through
      the fused ring attention;
    * decode — T == 1 with a cache (head-sharded or replicated);
    * chunked prefill — ``chunked=True`` with a cache: the chunk's K/V go
      in at the running position and its queries attend over the whole
      valid prefix (any padded tail sits after every real query, so the
      causal mask hides it).  Under ``seq_parallel="ring"`` with replicated
      heads each rank takes its S-stripe of the replicated cache and the
      chunk's shared queries ride the ring.
    """
    nd = _mesh().ndim
    T = x.shape[nd + 1]
    hp = head_parallel(cfg)
    kvs = kv_sharded(cfg)
    hd = cfg.head_dim
    H_loc = cfg.num_heads // ctx.tp if hp else cfg.num_heads
    KV_loc = cfg.kv_heads // ctx.tp if kvs else cfg.kv_heads
    causal = cfg.causal if causal is None else causal
    if positions is None:
        positions = torch.arange(T, device=x.device)

    decode = cache is not None and T == 1
    chunkfill = chunked and cache is not None and not decode
    token_parallel = ((not hp) and (not decode) and (not chunkfill)
                      and T % ctx.tp == 0 and ctx.tp > 1)
    # the sequence-parallel strategy: "ring" rotates K/V stripes as
    # one-sided puts folded with the online-softmax merge
    ring_attn = ctx.tp > 1 and not hp and not kvs \
        and resolve_seq_parallel(ctx.seq_parallel) == "ring"

    if token_parallel:
        t_loc = T // ctx.tp
        t0 = _rank_index(ctx.tp_group, nd + 1, x.device) * t_loc  # (*mesh, 1)
        x_me = _my_chunk(x, ctx.tp_group, 1, t_loc)
        pos_me = _my_chunk(positions.reshape(-1).expand(*_mesh().sizes, T),
                           ctx.tp_group, 0, t_loc).unsqueeze(-2)
    else:
        x_me, pos_me = x, positions

    lead = x_me.shape[:-1]
    q = col_matmul(x_me, lp["wq"], ctx, lp.get("bq")).reshape(*lead, H_loc, hd)
    k = col_matmul(x_me, lp["wk"], ctx, lp.get("bk")).reshape(*lead, KV_loc, hd)
    v = col_matmul(x_me, lp["wv"], ctx, lp.get("bv")).reshape(*lead, KV_loc, hd)
    if hp and not kvs and ctx.tp > 1:
        k = _slice_kv(k, cfg, ctx)
        v = _slice_kv(v, cfg, ctx)
    if cfg.rope_fraction > 0:
        q = rope(q, pos_me, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
        k = rope(k, pos_me, theta=cfg.rope_theta, fraction=cfg.rope_fraction)

    new_cache = cache
    if decode:
        new_cache = _update_cache(cache, k, v)
        pos = _per_row(new_cache.pos)
        attn = flash_attention(q, new_cache.k, new_cache.v, causal=True,
                               q_offset=pos - 1, valid_len=pos)
    elif chunkfill:
        if cache.seq_sharded:
            raise ValueError(
                "chunked prefill does not support a context-sharded cache")
        p0 = cache.pos
        _write_rows(cache.k, k, p0)
        _write_rows(cache.v, v, p0)
        new_cache = KVCache(cache.k, cache.v, p0 + T)
        s_all = cache.k.shape[nd + 1]
        if ring_attn and s_all % ctx.tp == 0:
            # the cache is replicated over "model": each rank folds its
            # S-stripe and the chunk's (shared) queries ride the ring
            s_loc = s_all // ctx.tp
            attn = flash_attention(
                q, _my_chunk(cache.k, ctx.tp_group, 1, s_loc),
                _my_chunk(cache.v, ctx.tp_group, 1, s_loc), causal=True,
                impl="ring", group=ctx.tp_group, q_offset=_per_row(p0),
                valid_len=_per_row(p0 + T), q_sharded=False)
        else:
            attn = flash_attention(q, cache.k, cache.v, causal=True,
                                   q_offset=_per_row(p0),
                                   valid_len=_per_row(p0 + T))
    elif token_parallel and ring_attn and cache is None and prefix_len == 0:
        # fused ring attention (token-parallel, no cache): the K/V shards
        # never gather; stripes rotate while the softmax state accumulates
        attn = flash_attention(q, k, v, causal=causal, impl="ring",
                               group=ctx.tp_group, q_sharded=True)
    elif token_parallel:
        # the keys must cover the whole sequence: gather over the TP group
        k_full = ompccl.allgather(k, ctx.tp_group, axis=1,
                                  invariant=ctx.inference)
        v_full = ompccl.allgather(v, ctx.tp_group, axis=1,
                                  invariant=ctx.inference)
        attn = flash_attention(q, k_full, v_full, causal=causal, q_offset=t0,
                               prefix_len=prefix_len)
        if cache is not None:            # prefill: persist the gathered K/V
            new_cache = _prefill_cache(cache, k_full, v_full, T)
    else:
        attn = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
        if cache is not None:            # prefill into a decode cache
            new_cache = _prefill_cache(cache, k, v, T)

    attn2 = attn.reshape(*attn.shape[:-2], H_loc * hd)
    if token_parallel:
        out_me = dot(attn2, gather_fsdp(lp["wo"], ctx, dim=1))
        out = ompccl.allgather(out_me, ctx.tp_group, axis=1,
                               invariant=ctx.inference)   # tokens back
    elif hp:
        out = row_matmul(attn2, lp["wo"], ctx)
    else:  # replicated heads: wo replicated over model
        out = dot(attn2, gather_fsdp(lp["wo"], ctx, dim=1))
    return out, new_cache


def _prefill_cache(cache: KVCache, k, v, T: int) -> KVCache:
    """Write a prompt's K/V at row 0 of the cache; its position is T."""
    zero = torch.zeros((), dtype=torch.int32, device=k.device)
    _write_rows(cache.k, k, zero)
    _write_rows(cache.v, v, zero)
    return KVCache(cache.k, cache.v, torch.full(
        _mesh().sizes, T, dtype=torch.int32, device=k.device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x, lp, ctx: ParallelCtx, *, act: str = "silu",
              names=("w_gate", "w_up", "w_down")):
    """SwiGLU/GeGLU column->row parallel MLP (GELU in jax's default tanh
    form)."""
    g, u, dwn = names
    h = col_matmul(x, lp[g], ctx)
    h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    h = h * col_matmul(x, lp[u], ctx)
    return row_matmul(h, lp[dwn], ctx)


# ---------------------------------------------------------------------------
# MoE (expert-parallel over the "model" axis)
# ---------------------------------------------------------------------------

def moe_capacity(t_loc: int, k: int, E: int, capacity_factor: float) -> int:
    """Per-expert slot capacity of the GShard dispatch: the true ceiling
    ``ceil((t_loc*k/E) * capacity_factor)``, the quotient rounded at 1e-9
    first so binary float dust cannot bump an exact product up a slot."""
    q = (t_loc * k / E) * capacity_factor
    return max(int(math.ceil(round(q, 9))), 1)


def moe_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx):
    """Top-k expert-parallel FFN on ``x (*mesh, B, T, d)``: experts sharded
    over "model" (E/tp a rank), each keeping a ZeRO-3 d-shard that is
    all-gathered at use.

    Regimes per call, as the reference picks them:

    * ``"a2a"`` — tokens sliced over "model", one ``ompccl.alltoall`` out
      and back (prefill, and decode with at least one token a rank);
    * ``"replicated"`` — fewer tokens than ranks: the dispatch is
      replicated across the EP group, each rank runs its experts, and a
      partial combine is summed over the group;
    * ``"local"`` — tp == 1 or E does not divide.

    Capacity is :func:`moe_capacity` (at least 4); overflow drops, with
    the drop count recorded into the context's ``dispatch_stats`` frame.
    ``ctx.dispatch_impl`` = ``"fused"``/``"host"`` swaps the a2a regime's
    collectives for the dropless one-sided ring of
    :mod:`repro_torch.kernels.moe_dispatch`.  Every regime's grouped GEMMs
    run the expert-MLP kernel on the card, with each block's live rows
    counted from the ``keep`` mask.
    """
    if ctx.expert2d:
        raise NotImplementedError(
            "expert2d placement (MoE experts over model x data) is not "
            "ported yet: ROADMAP queue 1, item 12")
    mesh = _mesh()
    nd = mesh.ndim
    lead = x.shape[:nd]
    R = mesh.size
    B, T, d = x.shape[nd:]
    E, k = cfg.num_experts, cfg.experts_per_token
    tp = ep = ctx.tp
    E_loc = E // ep if (E % ep == 0 and ep > 1) else E
    if E % ep == 0 and ep > 1 and (B * T) % tp == 0 and B * T >= tp:
        regime = "a2a"
    elif E % ep == 0 and ep > 1:
        regime = "replicated"
    else:
        regime = "local"
        E_loc = E

    flat = x.reshape(*lead, B * T, d)
    toks_local = flat                     # shared-expert input (my tokens)
    if regime == "a2a":
        t_loc = (B * T) // tp             # tokens sliced over "model" only
        mine = group_rank(ctx.tp_group, mesh, x.device)[..., None] * t_loc \
            + torch.arange(t_loc, device=x.device)   # my rows, per rank
        toks = _take_rows(flat, mine)
    else:
        toks, t_loc = flat, B * T
    top_w, top_e = route_topk(toks, lp["router"], k)         # (*mesh, t_loc, k)

    wg = gather_fsdp(lp["w_gate_e"], ctx, dim=1)              # (E_loc, d, ffm)
    wu = gather_fsdp(lp["w_up_e"], ctx, dim=1)
    wd = gather_fsdp(lp["w_down_e"], ctx, dim=2)              # (E_loc, ffm, d)

    # the dropless one-sided dispatch: opt-in by the ParallelCtx knob,
    # where the a2a regime holds on a single-axis EP group (the put ring)
    impl = "a2a"
    if regime == "a2a" and len(ctx.ep_group.axes) == 1:
        impl = resolve_dispatch_impl(ctx.dispatch_impl)
    if impl in ("fused", "host"):
        combined = moe_dispatch(toks, top_e, top_w, wg, wu, wd,
                                ctx.ep_group, impl=impl)
        if "w_gate_s" in lp:  # shared experts: full rows, then my slice
            shared = mlp_block(toks_local, lp, ctx,
                               names=("w_gate_s", "w_up_s", "w_down_s"))
            combined = combined + _take_rows(shared, mine)
        out = ompccl.allgather(combined, ctx.tp_group, axis=0,
                               invariant=ctx.inference)
        return out.reshape(*lead, B, T, d)

    cap = max(moe_capacity(t_loc, k, E, cfg.capacity_factor), 4)
    # slot assignment: position of each (token, choice) within its expert
    e_flat = top_e.reshape(R, t_loc * k)
    slot = expert_slots(e_flat, E)
    keep = slot < cap
    addr = e_flat * cap + slot.clamp(0, cap - 1)
    dropped = (~keep).sum(-1).float().view(lead)
    default_context().dispatch_stats.record(
        moe_dropped=dropped, moe_routed=torch.full_like(dropped, t_loc * k))
    buf = scatter_rows(toks.reshape(R, t_loc, d), k, keep, addr, E * cap)
    counts = kept_counts(e_flat, keep, E)                     # (R, E)
    gates = (keep[..., None] * top_w.reshape(R, -1)[..., None]).to(x.dtype)

    if regime == "a2a":
        recv = ompccl.alltoall(buf.view(*lead, ep, E_loc * cap, d),
                               ctx.ep_group, split_axis=0, concat_axis=0)
        # each block's live rows: the sources' kept counts, laid out as the
        # blocks landed (metadata the reference does not ship: it runs
        # every padded row; not logged)
        live = XlaBackend().alltoall(counts.view(*lead, ep, E_loc),
                                     ctx.ep_group, mesh, split_axis=0,
                                     concat_axis=0)
        out_e = expert_mlp(recv.reshape(*lead, ep, E_loc, cap, d), wg, wu,
                           wd, live)
        ret = ompccl.alltoall(out_e.reshape(*lead, ep, E_loc * cap, d),
                              ctx.ep_group, split_axis=0, concat_axis=0)
        picked = ret.reshape(R, E * cap, d)[
            torch.arange(R, device=x.device)[:, None], addr]
        combined = (picked * gates).reshape(*lead, t_loc, k, d).sum(dim=-2)
    elif regime == "replicated":
        # the dispatch is replicated across the EP group; run my experts
        me = group_rank(ctx.ep_group, mesh, x.device)
        expert_in = _take_rows(buf.view(*lead, ep, E_loc, cap, d), me)
        live = _take_rows(counts.view(*lead, ep, E_loc), me)
        out_e = expert_mlp(expert_in, wg, wu, wd, live)
        # partial combine: only my experts contribute; summed over the group
        local = addr - (me.reshape(R) * E_loc * cap)[:, None]
        mine = (local >= 0) & (local < E_loc * cap)
        ret_me = out_e.reshape(R, E_loc * cap, d)
        picked = ret_me[torch.arange(R, device=x.device)[:, None],
                        local.clamp(0, E_loc * cap - 1)]
        picked = torch.where(mine[..., None], picked,
                             torch.zeros((), dtype=x.dtype, device=x.device))
        combined = (picked * gates).reshape(*lead, t_loc, k, d).sum(dim=-2)
        combined = ompccl.allreduce(combined, ctx.ep_group)
    else:
        out_e = expert_mlp(buf.view(*lead, E, cap, d), wg, wu, wd,
                           counts.view(*lead, E))
        picked = out_e.reshape(R, E * cap, d)[
            torch.arange(R, device=x.device)[:, None], addr]
        combined = (picked * gates).reshape(*lead, t_loc, k, d).sum(dim=-2)

    if "w_gate_s" in lp:  # shared experts
        # the TP col->row shared MLP needs the SAME rows on every "model"
        # rank (its row-parallel sum adds feature partials of one row), so
        # it runs on the full token set; the a2a regime then takes my slice
        shared = mlp_block(toks_local, lp, ctx,
                           names=("w_gate_s", "w_up_s", "w_down_s"))
        if regime == "a2a":
            shared = _take_rows(shared, mine)
        combined = combined + shared

    if regime == "a2a":
        out = ompccl.allgather(combined, ctx.tp_group, axis=0,
                               invariant=ctx.inference)   # tokens back
    else:
        out = combined
    return out.reshape(*lead, B, T, d)
