"""Manual-SPMD layer library on stacked ranks (dense, GQA MoE, MLA MoE,
VLM, RWKV6 and Zamba2 families).

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

A context(seq)-sharded decode cache (``seq_sharded``) holds the S-chunk
``[r·s_loc, (r+1)·s_loc)`` on data rank r: the owner alone writes a
step's row, and :func:`cp_decode_attention` merges the ranks' partials
from row 5's kernel with three OMPCCL all-reduces.  Under
``use_ring_matmul`` the column-parallel GEMMs rotate W's ZeRO-3 shards
around the data ring instead of gathering them
(:func:`ring_fsdp_matmul`).  Under ``expert2d`` the MoE experts are
sharded over model x data instead: each rank owns whole experts at full d
and ff, and :func:`moe_block` dispatches over the combined EP group with
no ZeRO-3 gather of them.

The decode and chunk-prefill branches write the new K/V (MLA: latent)
rows into the cache in place (the reference returns an updated copy): a
step's cache is the engine's own tensor, so no second copy of it is ever
held.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import ompccl
from ..core.backends import XlaBackend, group_rank
from ..core.context import default_context, use_default
from ..core.rma import ompx_put
from ..kernels.flash_attention.kernel import flash_attention_kernel
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.moe_dispatch.fused import expert_slots, kept_counts, scatter_rows
from ..kernels.moe_dispatch.kernel import expert_mlp
from ..kernels.moe_dispatch.ops import moe_dispatch
from ..kernels.moe_dispatch.ref import route_topk
from ..kernels.plan import (RingPlan, resolve_dispatch_impl, resolve_ring_impl,
                            resolve_seq_parallel)
from .config import ModelConfig, ParallelCtx
from .schema import head_parallel, kv_sharded, vocab_sharded

__all__ = [
    "rmsnorm", "layernorm", "rope", "gather_fsdp", "tp_allreduce",
    "col_matmul", "row_matmul", "embed_lookup", "ce_loss", "Q8Gather",
    "KVCache", "cp_decode_attention", "local_kv_heads", "MLACache",
    "mla_block", "attention_block", "mlp_block", "gelu_mlp_block",
    "moe_capacity", "moe_block", "dot", "flat_heads", "ring_fsdp_matmul",
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
        return Q8Gather.apply(w, ctx, dim)
    return ompccl.allgather(w, ctx.fsdp_group, axis=dim,
                            invariant=ctx.inference)


class Q8Gather(torch.autograd.Function):
    """The int8-wire ZeRO-3 gather (ZeRO++ qwZ-style; the reference's
    ``_q8_gather`` custom VJP).

    Forward: each rank quantizes its shard with one per-tensor scale, the
    int8 codes and the scales are all-gathered, dequantized to the
    weight's dtype, and each rank's own shard is spliced back at full
    precision.  Backward: the exact reduce-scatter of the cotangent over
    the same group (a straight-through estimator: the gradient wire stays
    uncompressed), logged against the context the forward ran in, as the
    reference's backward is logged once for its trace."""

    @staticmethod
    def forward(fctx, w, ctx: ParallelCtx, dim: int):
        from ..distributed.compression import quantize_int8

        dctx = default_context()
        mesh = dctx.require_mesh()
        nd = mesh.ndim
        fctx.pctx, fctx.dim, fctx.dctx = ctx, dim, dctx
        q, s = quantize_int8(w, lead=nd)
        qq = ompccl.allgather(q, ctx.fsdp_group, axis=dim,
                              invariant=ctx.inference)
        ss = ompccl.allgather(s.reshape(*mesh.sizes, 1), ctx.fsdp_group,
                              axis=0, invariant=ctx.inference)   # (*mesh, n)
        n = ss.shape[-1]
        d = nd + dim
        shard = qq.shape[d] // n
        full = qq.unflatten(d, (n, shard)).float()
        scales = ss.reshape(*mesh.sizes, *([1] * dim), n,
                            *([1] * (full.dim() - d - 1)))
        full = (full * scales).to(w.dtype)
        # my own shard back at full precision
        idx = torch.arange(n, device=w.device).reshape(
            [n if i == d else 1 for i in range(full.dim())])
        mine = idx == _rank_index(ctx.fsdp_group, full.dim(), w.device)
        full = torch.where(mine, w.unsqueeze(d), full)
        return full.flatten(d, d + 1)

    @staticmethod
    def backward(fctx, g):
        with use_default(fctx.dctx):
            gw = ompccl.reducescatter(g, fctx.pctx.fsdp_group, axis=fctx.dim)
        return gw.to(g.dtype), None, None


def tp_allreduce(x, ctx: ParallelCtx):
    if ctx.tp <= 1:
        return x
    return ompccl.allreduce(x, ctx.tp_group)


def ring_fsdp_matmul(x, w_local, ctx: ParallelCtx):
    """Cannon-style overlap of the ZeRO-3 gather (the reference's
    ``ring_fsdp_matmul``, paper §4.4 applied to the weight gather): y = x @
    W with W row-sharded over ``fsdp_group``.

    Instead of all-gathering W and running one GEMM, W's shards circulate
    around the group's ring by ``ompx_put`` on the stacked rank dim, on the
    :class:`~repro_torch.kernels.plan.RingPlan` schedule: bidirectional
    (``ceil((n-1)/2)`` exchange steps) when ``ctx.ring_impl`` resolves to
    ``"fused"``, clockwise (``n - 1``) for ``"host"``.  Each step sends
    first, then multiplies the stripe it holds by x's matching block of
    columns (rank ``idx`` holds the shard of rank ``(idx ∓ s) mod n`` at
    step ``s``).  The partial products (the port's :func:`dot`) add up in
    f32 in schedule order and are cast once.  Autograd differentiates the
    puts (each a roll of the rank dim); the backward logs no put, as the
    transpose of the reference's ``ppermute`` does not go through
    ``ompx_put``.  Without an FSDP group or sharded weights: one ``dot``.
    """
    if ctx.fsdp <= 1 or not ctx.fsdp_params:
        return dot(x, w_local)
    group = ctx.fsdp_group
    n = group.axis_size(_mesh())
    dshard = w_local.shape[-2]
    idx = _rank_index(group, x.dim() + 1, x.device)     # (*mesh, 1, ..., 1)
    blocks = x.unflatten(-1, (n, dshard))
    direction = ("bidi" if resolve_ring_impl(ctx.ring_impl) == "fused"
                 else "cw")
    acc = None

    def partial_gemm(acc, stripe, src):
        xs = torch.gather(blocks, -2, src.expand(*blocks.shape[:-2], 1,
                                                 dshard)).squeeze(-2)
        y = dot(xs, stripe).float()
        return y if acc is None else acc + y

    cw = ccw = w_local
    for st in RingPlan(n=n, direction=direction).schedule():
        # forwards first: the next stripes fly while this step's GEMMs run
        cw_next = ompx_put(cw, group, shift=1) if st.send_cw else cw
        ccw_next = ompx_put(ccw, group, shift=-1) if st.send_ccw else ccw
        if st.compute_cw:
            acc = partial_gemm(acc, cw, (idx - st.index) % n)
        if st.compute_ccw:
            acc = partial_gemm(acc, ccw, (idx + st.index) % n)
        cw, ccw = cw_next, ccw_next
    return acc.to(x.dtype)


def col_matmul(x, w_local, ctx: ParallelCtx, bias_local=None):
    """Megatron column-parallel: x (…, d) × W (d/fsdp, out/tp) -> (…, out/tp),
    through the weight ring under ``ctx.use_ring_matmul``."""
    if ctx.use_ring_matmul:
        y = ring_fsdp_matmul(x, w_local, ctx)
    else:
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


def _embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`_take_rows` through ``F.embedding`` over the ranks' tables
    laid end to end: the same rows, and on the card a backward that sums a
    repeated token's rows in a fixed order (an indexed gather's backward
    adds them with atomics, in an order that changes from run to run)."""
    mesh = _mesh()
    R, V = mesh.size, table.shape[-2]
    t = table.reshape(R * V, table.shape[-1])
    off = torch.arange(R, device=idx.device)[:, None] * V
    rows = F.embedding(idx.reshape(R, -1).long() + off, t)
    return rows.reshape(*idx.shape, t.shape[-1])


def embed_lookup(tokens, table_local, cfg: ModelConfig, ctx: ParallelCtx):
    """tokens ``(*mesh, B, T)`` int; table_local ``(*mesh, V/tp, d)``."""
    if not vocab_sharded(cfg) or ctx.tp <= 1:
        return _embed_rows(table_local, tokens)
    vloc = table_local.shape[-2]
    off = _rank_index(ctx.tp_group, tokens.dim(), tokens.device) * vloc
    local = tokens - off
    hit = (local >= 0) & (local < vloc)
    e = _embed_rows(table_local, local.clamp(0, vloc - 1))
    e = torch.where(hit[..., None], e, torch.zeros_like(e))
    return tp_allreduce(e, ctx)


def ce_loss(h, head_local, targets, cfg: ModelConfig, ctx: ParallelCtx,
            weights=None):
    """Cross-entropy with vocab-sharded logits: each rank's mean loss, f32,
    shaped ``(*mesh,)``.

    h ``(*mesh, B, T, d)``; head_local ``(*mesh, d, V/tp)`` (or the whole
    vocabulary); targets ``(*mesh, B, T)``.  The softmax statistics reduce
    over the TP group through OMPCCL max and sum all-reduces; the max shift
    carries no gradient (the CE gradient is exact whatever the shift).  The
    loss comes out replicated over the TP group, so a backward seeded with
    every replica's loss scales the gradients by ``tp``: the train step
    seeds the mean of the replicas."""
    nd = _mesh().ndim
    logits = dot_f32(h, head_local)                   # (*mesh, B, T, V/tp)
    sharded = vocab_sharded(cfg) and ctx.tp > 1
    m = logits.detach().amax(dim=-1)
    if sharded:
        m = ompccl.allreduce(m, ctx.tp_group, op="max")
    m = m.detach()
    z = torch.exp(logits - m[..., None]).sum(dim=-1)
    if sharded:
        z = ompccl.allreduce(z, ctx.tp_group)
        vloc = head_local.shape[-1]
        off = _rank_index(ctx.tp_group, targets.dim(), targets.device) * vloc
        local = targets.long() - off
        hit = (local >= 0) & (local < vloc)
        tgt = torch.gather(logits, -1, local.clamp(0, vloc - 1)[..., None]
                           )[..., 0]
        tgt = torch.where(hit, tgt, torch.zeros_like(tgt))
        tgt = ompccl.allreduce(tgt, ctx.tp_group)
    else:
        tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.log(z) + m - tgt
    dims = tuple(range(nd, nll.dim()))
    if weights is not None:
        w = weights.float()
        return (nll * w).sum(dims) / torch.clamp(w.sum(dims), min=1.0)
    return nll.mean(dims)


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


def _update_cache(cache: KVCache, k_new, v_new, group=None) -> KVCache:
    """Write one decode step's K/V at ``cache.pos`` (scalar or per slot).

    A context-sharded cache (one position a rank) is written by its owner
    only: the rank of ``group`` whose chunk ``[r·s_loc, (r+1)·s_loc)``
    holds ``pos`` writes at ``pos - r·s_loc``; every other rank writes its
    own row at the clamped offset back unchanged, so the write is one
    indexed put of one row a rank."""
    if not cache.seq_sharded:
        _write_rows(cache.k, k_new, cache.pos)
        _write_rows(cache.v, v_new, cache.pos)
        return KVCache(cache.k, cache.v, cache.pos + 1)
    mesh = _mesh()
    nd = mesh.ndim
    if cache.pos.dim() > nd:
        # the reference's per-slot write ignores seq_sharded: it would
        # write a slot's global position into a chunk's local rows
        raise ValueError(
            "per-slot positions (continuous batching) do not support a "
            "context-sharded cache: its rows are addressed by one position "
            "a rank")
    dev = cache.k.device
    s_loc = cache.k.shape[nd + 1]
    lo = group_rank(group, mesh, dev) * s_loc
    pos = cache.pos.to(dev).long()
    local = (pos - lo).clamp(0, s_loc - 1)                    # (*mesh,)
    mine = ((pos >= lo) & (pos < lo + s_loc)).reshape(
        *mesh.sizes, 1, 1, 1, 1)
    R, B = mesh.size, cache.k.shape[nd]
    at = (torch.arange(R, device=dev)[:, None],
          torch.arange(B, device=dev)[None, :], local.reshape(R, 1))
    for c, new in ((cache.k, k_new), (cache.v, v_new)):
        old = c.view(R, B, *c.shape[nd + 1:])[at].reshape(new.shape)
        _write_rows(c, torch.where(mine, new.to(c.dtype), old), local)
    return KVCache(cache.k, cache.v, cache.pos + 1, seq_sharded=True)


def cp_decode_attention(q, cache: KVCache, group, *,
                        scale: Optional[float] = None):
    """Decode attention over a context(S)-sharded cache (distributed
    flash-decode): q ``(*mesh, B, 1, H, D)``; ``cache.k``/``cache.v``
    ``(*mesh, B, s_loc, KH, D|Dv)``, rank r of ``group`` holding keys
    ``[r·s_loc, (r+1)·s_loc)``; ``cache.pos`` ``(*mesh,)`` already advanced
    past the new row, so the first ``pos`` keys are visible.

    Each rank's partial is row 5's kernel over its chunk (no causal mask,
    ``valid_len = clamp(pos - r·s_loc, 0, s_loc)``) with the rows'
    log-sum-exp; the partials merge through the reference's three OMPCCL
    all-reduces over ``group``: the max ``M`` of the rows' statistic, the
    sum of the weights ``exp(lse_r - M)`` (``(B, KH, G)`` f32 each) and
    the sum of the weighted outputs (``(B, KH, G, Dv)`` f32).  A rank
    whose chunk holds no visible key (the kernel and its plain version
    write its output 0 and its lse +inf) enters with the statistic -inf
    and weight 0."""
    mesh = _mesh()
    nd = mesh.ndim
    lead = q.shape[:nd]
    B, _, H, _ = q.shape[nd:]
    s_loc, KH = cache.k.shape[nd + 1], cache.k.shape[nd + 2]
    Dv = cache.v.shape[-1]
    G = H // KH
    dev = q.device
    start = group_rank(group, mesh, dev) * s_loc
    valid = (cache.pos.to(dev).long() - start).clamp(0, s_loc)   # (*mesh,)
    out, lse = flash_attention_kernel(
        q, cache.k, cache.v, causal=False, scale=scale,
        valid_len=valid[..., None].expand(*lead, B), return_lse=True)
    has = (valid > 0).reshape(*lead, 1, 1, 1)
    stat = torch.where(has, lse.reshape(*lead, B, KH, G), float("-inf"))
    m = ompccl.allreduce(stat, group, op="max")
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(stat - m_safe)                               # 0 where empty
    l = ompccl.allreduce(w, group)
    acc = ompccl.allreduce(
        w[..., None] * out.float().reshape(*lead, B, KH, G, Dv), group)
    res = acc / torch.clamp(l, min=1e-30)[..., None]
    return res.reshape(*lead, B, 1, H, Dv).to(q.dtype)


def cp_decode_attention_plain(q, cache: KVCache, group, *,
                              scale: Optional[float] = None):
    """The reference's einsum form of :func:`cp_decode_attention` in plain
    torch (the same three all-reduces): f32 scores of every chunk row,
    masked past ``pos``, merged by (max, sum, acc)."""
    mesh = _mesh()
    nd = mesh.ndim
    lead = q.shape[:nd]
    B, _, H, D = q.shape[nd:]
    s_loc, KH = cache.k.shape[nd + 1], cache.k.shape[nd + 2]
    Dv = cache.v.shape[-1]
    G = H // KH
    dev = q.device
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(*lead, B, KH, G, D) * scale
    s = torch.einsum("...bhgd,...bshd->...bhgs", qf, cache.k.float())
    k_pos = _rank_index(group, s.dim(), dev) * s_loc \
        + torch.arange(s_loc, device=dev)
    vis = k_pos < cache.pos.to(dev).reshape(*lead, *([1] * (s.dim() - nd)))
    s = torch.where(vis, s, float("-inf"))
    m = ompccl.allreduce(s.amax(dim=-1), group, op="max")
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(vis, torch.exp(s - m_safe[..., None]), 0.0)
    l = ompccl.allreduce(p.sum(dim=-1), group)
    acc = ompccl.allreduce(
        torch.einsum("...bhgs,...bshd->...bhgd", p, cache.v.float()), group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(*lead, B, 1, H, Dv).to(q.dtype)


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
    * decode — T == 1 with a cache: head-sharded or replicated, or
      context(S)-sharded over the data axis (:func:`cp_decode_attention`);
      a prompt prefilled into a sharded cache lands at local row 0 on
      every data rank, which holds while ``T <= S / data``: each later
      position is rewritten by its owner before the mask lets a query
      see it;
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
    if cache is not None and cache.seq_sharded and not decode \
            and not chunkfill and T > cache.k.shape[nd + 1]:
        raise ValueError(
            f"a prompt of {T} tokens does not fit a context-sharded cache's "
            f"{cache.k.shape[nd + 1]} rows a rank (the prompt lands at local "
            f"row 0 of every data rank: T <= S / data)")
    if decode and cache.seq_sharded:
        new_cache = _update_cache(cache, k, v, ctx.fsdp_group)
        attn = cp_decode_attention(q, new_cache, ctx.fsdp_group,
                                   scale=hd ** -0.5)
    elif decode:
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
# MLA (DeepSeek)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLACache:
    """One layer's latent cache on stacked ranks: ``c`` ``(*mesh, B, S,
    kv_lora_rank)`` and the rope'd shared key ``kr`` ``(*mesh, B, S, dr)``
    (views of the stacked cache, replicated over "model"); ``pos`` is
    ``(*mesh,)`` or ``(*mesh, B)``."""

    c: torch.Tensor
    kr: torch.Tensor
    pos: torch.Tensor


def mla_block(x, lp: Dict[str, torch.Tensor], cfg: ModelConfig,
              ctx: ParallelCtx, *, positions=None,
              cache: Optional[MLACache] = None, chunked: bool = False):
    """DeepSeek-V3 multi-head latent attention on x ``(*mesh, B, T, d)``;
    returns ``(out, cache')``.  Heads are sharded over "model" where they
    divide ``MAX_TP``; the latent path is replicated (the cache is small).

    * prefill (and the forward) — per-head K and V decompressed from the
      latent in f32, then flash attention with D = dn + dr, Dv = dv; a
      cache gets the latents at row 0;
    * chunked prefill — ``chunked=True`` with a cache: the chunk's latents
      go in at ``cache.pos`` and its queries attend over K/V decompressed
      from the whole valid latent prefix (``q_offset``, ``valid_len``);
    * decode — T == 1 with a cache: the *absorbed* form, f32 einsums in the
      latent space against the cache under a mask past each row's
      position (scalar or per slot), as the reference computes it outside
      any kernel; only the final up-projection touches head dims.
    """
    nd = _mesh().ndim
    T = x.shape[nd + 1]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr_rank = cfg.kv_lora_rank
    H_loc = cfg.num_heads // ctx.tp if head_parallel(cfg) else cfg.num_heads
    if positions is None:
        positions = torch.arange(T, device=x.device)
    scale = (dn + dr) ** -0.5
    lead = x.shape[:-1]

    cq = rmsnorm(col_matmul(x, lp["wq_a"], ctx), lp["q_norm"], cfg.norm_eps)
    q = col_matmul(cq, lp["wq_b"], ctx).reshape(*lead, H_loc, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)

    ckv = col_matmul(x, lp["wkv_a"], ctx)                  # (…, kr + dr)
    c = rmsnorm(ckv[..., :kr_rank], lp["kv_norm"], cfg.norm_eps)
    k_rope = rope(ckv[..., None, kr_rank:], positions, theta=cfg.rope_theta)

    wkv_b = gather_fsdp(lp["wkv_b"], ctx, dim=0)           # (kr, H_loc·(dn+dv))
    wkv_b = wkv_b.reshape(*wkv_b.shape[:nd], kr_rank, H_loc, dn + dv)

    new_cache = cache
    if cache is not None and T == 1:
        # absorbed decode
        _write_rows(cache.c, c, cache.pos)
        _write_rows(cache.kr, k_rope[..., 0, :], cache.pos)
        new_cache = MLACache(cache.c, cache.kr, cache.pos + 1)
        q_lat = torch.einsum("...bthn,...khn->...bthk", q_nope.float(),
                             wkv_b[..., :dn].float())      # (…, B, 1, H, kr)
        c_all, kr_all = new_cache.c.float(), new_cache.kr.float()
        s = torch.einsum("...bthk,...bsk->...bhs", q_lat, c_all) \
            + torch.einsum("...bthr,...bsr->...bhs", q_rope.float(), kr_all)
        s = s * scale
        k_pos = torch.arange(c_all.shape[-2], device=x.device)
        vis = k_pos < _per_row(new_cache.pos)[..., None, None].to(x.device)
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        ctx_lat = torch.einsum("...bhs,...bsk->...bhk", p, c_all)
        attn = torch.einsum("...bhk,...khn->...bhn", ctx_lat,
                            wkv_b[..., dn:].float())       # (…, B, H, dv)
        attn = attn.unsqueeze(-3).to(x.dtype)              # (…, B, 1, H, dv)
    elif chunked and cache is not None:
        # chunked prefill: append the latents at cache.pos, attend over the
        # decompressed valid prefix (the causal mask and q_offset hide the
        # padded tail and the unwritten suffix, as in attention_block)
        p0 = cache.pos
        _write_rows(cache.c, c, p0)
        _write_rows(cache.kr, k_rope[..., 0, :], p0)
        new_cache = MLACache(cache.c, cache.kr, p0 + T)
        kv_all = torch.einsum("...bsk,...khn->...bshn", cache.c.float(),
                              wkv_b.float()).to(x.dtype)
        k_all = torch.cat(
            [kv_all[..., :dn],
             cache.kr.to(x.dtype)[..., None, :].expand(
                 *cache.kr.shape[:-1], H_loc, dr)], dim=-1)
        v_all = kv_all[..., dn:].contiguous()
        del kv_all
        qkr = torch.cat([q_nope, q_rope], dim=-1)
        attn = flash_attention(qkr, k_all, v_all, causal=True, scale=scale,
                               q_offset=_per_row(p0),
                               valid_len=_per_row(p0 + T))
    else:
        kv = torch.einsum("...btk,...khn->...bthn", c.float(),
                          wkv_b.float()).to(x.dtype)       # decompress
        k = torch.cat([kv[..., :dn],
                       k_rope.expand(*k_rope.shape[:-2], H_loc, dr)], dim=-1)
        v = kv[..., dn:].contiguous()
        qkr = torch.cat([q_nope, q_rope], dim=-1)
        attn = flash_attention(qkr, k, v, causal=True, scale=scale)
        if cache is not None:  # prefill the latent cache
            zero = torch.zeros((), dtype=torch.int32, device=x.device)
            _write_rows(cache.c, c, zero)
            _write_rows(cache.kr, k_rope[..., 0, :], zero)
            new_cache = MLACache(cache.c, cache.kr, torch.full(
                _mesh().sizes, T, dtype=torch.int32, device=x.device))

    out = row_matmul(attn.reshape(*attn.shape[:-2], H_loc * dv), lp["wo"],
                     ctx)
    return out, new_cache


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


def gelu_mlp_block(x, lp, ctx: ParallelCtx):
    """The plain two-matmul GELU MLP of the audio encoder (hubert): ``w_up``
    then ``w_down``, GELU in jax's default tanh form."""
    h = F.gelu(col_matmul(x, lp["w_up"], ctx), approximate="tanh")
    return row_matmul(h, lp["w_down"], ctx)


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
    """Top-k expert-parallel FFN on ``x (*mesh, B, T, d)``.

    EP layouts, as the reference's:

    * default — experts sharded over "model" (E/tp a rank), each keeping a
      ZeRO-3 d-shard that is all-gathered at use;
    * ``ctx.expert2d`` — experts sharded over ("model", "data") (E/ep a
      rank, ep = ``ctx.ep_size``), each rank whole experts at full d and
      ff: the dispatch runs over the combined EP group and no expert
      weight is gathered.

    Regimes per call, as the reference picks them:

    * ``"a2a"`` — tokens sliced over "model" only, one ``ompccl.alltoall``
      over the EP group out and back (prefill, and decode with at least
      one token a model rank);
    * ``"replicated"`` — fewer tokens than model ranks: the dispatch is
      replicated across the EP group (expert2d first all-gathers the
      data-sharded tokens over "data"), each rank runs its experts, a
      partial combine is summed over the group (expert2d then keeps its
      own data shard's rows);
    * ``"local"`` — tp == 1 or E does not divide.

    Capacity is :func:`moe_capacity` (at least 4); overflow drops, with
    the drop count recorded into the context's ``dispatch_stats`` frame.
    ``ctx.dispatch_impl`` = ``"fused"``/``"host"`` swaps the a2a regime's
    collectives for the dropless one-sided ring of
    :mod:`repro_torch.kernels.moe_dispatch` where the EP group has one
    axis (expert2d's two-axis group keeps the all-to-all, as the
    reference's does).  Every regime's grouped GEMMs
    run the expert-MLP kernel on the card, with each block's live rows
    counted from the ``keep`` mask.

    Gradient: every regime is differentiable with respect to ``x``, the
    router and the three expert weights (their ZeRO-3 gathers reduce-
    scatter in the backward).  On the card the a2a, replicated and local
    regimes run the expert-MLP kernel forward (row 7, again under remat)
    and its gradient kernel backward (row 12,
    :class:`~repro_torch.kernels.moe_dispatch.kernel.ExpertMLPFn`); the
    fused and host modes run the fused dispatch kernel forward (row 8) and
    its gradient kernel backward (row 13,
    :class:`~repro_torch.kernels.moe_dispatch.fused.FusedDispatchFn`).  The
    routing (softmax, top-k, the renormalized gates), the scatter
    (``index_copy_``), the collectives and the combine's gather stay torch
    ops under autograd; on the CPU the plain versions run under autograd
    in the kernels' place.
    """
    mesh = _mesh()
    nd = mesh.ndim
    lead = x.shape[:nd]
    R = mesh.size
    B, T, d = x.shape[nd:]
    E, k = cfg.num_experts, cfg.experts_per_token
    tp = ctx.tp
    ep2d = ctx.expert2d and ctx.ep_size > 1 and E % ctx.ep_size == 0
    ep = ctx.ep_size if ep2d else tp
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
    elif regime == "replicated" and ep2d and ctx.fsdp > 1:
        # decode: the tokens are data-sharded; gather them so the dispatch
        # is the same on every rank of the combined group
        toks = ompccl.allgather(flat, ctx.fsdp_group, axis=0,
                                invariant=ctx.inference)
        t_loc = B * T * ctx.fsdp
    else:
        toks, t_loc = flat, B * T
    top_w, top_e = route_topk(toks, lp["router"], k)         # (*mesh, t_loc, k)

    if ep2d:
        # expert2d: the weights already hold full d and ff
        wg, wu, wd = lp["w_gate_e"], lp["w_up_e"], lp["w_down_e"]
    else:
        wg = gather_fsdp(lp["w_gate_e"], ctx, dim=1)          # (E_loc, d, ffm)
        wu = gather_fsdp(lp["w_up_e"], ctx, dim=1)
        wd = gather_fsdp(lp["w_down_e"], ctx, dim=2)          # (E_loc, ffm, d)

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
        if ep2d and ctx.fsdp > 1:        # back to my data shard's rows
            rows = group_rank(ctx.fsdp_group, mesh, x.device)[..., None] \
                * (B * T) + torch.arange(B * T, device=x.device)
            combined = _take_rows(combined, rows)
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
