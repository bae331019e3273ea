"""The flash-attention kernel (``csrc/flash_attention.cu``) and its wrapper.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention/
kernel.py:80``, ``pallas_call`` at :125).  What bounds it on the H100 and
what its design does about that is noted in the CUDA source.  On CPU tensors
the wrapper computes the plain version, :func:`.ref.flash_attention_ref`.

On the card the launch takes the route :func:`..plan.attention_route`
picks (counted in ``flash_attention_kernel.route_launches``).  On the
tensor-core route a grid that leaves the card mostly empty (a decode step)
splits each tile's keys over :func:`..plan.plan_key_splits` blocks; their
f32 partial states are merged by the combine kernel of the same source
(counted in ``flash_attention_kernel.combine_launches``), whose plain
version is the ring attention's merge monoid (:func:`flash_combine_plain`).

Training goes through :class:`FlashAttention`: its forward launches the
kernel with the rows' log-sum-exp, its backward the gradient kernel of
``csrc/flash_attention_bwd.cu`` on the route
:func:`..plan.attention_bwd_route` picks (counted in
``flash_attention_bwd_kernel.launches`` and ``.route_launches``; plain
version :func:`flash_attention_bwd_plain`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch

from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import (FLASH_BQ, attention_bwd_route, attention_route,
                    default_planner, key_split_tiles, plan_key_splits)
from ..ring_attention.kernel import (empty_state, finalize_state,
                                     merge_states, stripe_mask, stripe_state)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention_kernel", "flash_attention_plain",
           "flash_attention_split_plain", "flash_combine_kernel",
           "flash_combine_plain", "flash_attention_bwd_kernel",
           "flash_attention_bwd_plain", "FlashAttention",
           "flash_attention_grad"]

Offsets = Union[int, torch.Tensor]


def _per_row(x: Offsets, lead, device) -> torch.Tensor:
    """An int or a tensor broadcast to the leading (batch) dims, as int32."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(lead)


def _key_tile(q, k, v, block: Optional[int]) -> int:
    """The key tile the kernel stages: the planner's, at most ``block``."""
    return default_planner().plan_attention_block(
        q.shape[-3], k.shape[-3], q.shape[-1], v.shape[-1], q.dtype,
        block=512 if block is None else block)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: Offsets = 0, prefix_len: int = 0,
                          scale: Optional[float] = None,
                          block: Optional[int] = None,
                          valid_len: Optional[Offsets] = None,
                          return_lse: bool = False):
    """The plain version over any leading dims: ``q (..., Tq, H, D)``,
    ``k (..., Tk, KH, D)``, ``v (..., Tk, KH, Dv)``; the offsets broadcast
    to the leading dims.  It folds the kernel's key tile per update.  With
    ``return_lse`` also the rows' log-sum-exp ``(..., Tq, H)`` f32."""
    lead = q.shape[:-3]
    block = _key_tile(q, k, v, block)
    if valid_len is None:
        valid_len = k.shape[-3]
    out = flash_attention_ref(
        q.reshape(-1, *q.shape[-3:]), k.reshape(-1, *k.shape[-3:]),
        v.reshape(-1, *v.shape[-3:]), causal=causal,
        q_offset=_per_row(q_offset, lead, q.device).reshape(-1),
        prefix_len=prefix_len, scale=scale, block=block,
        valid_len=_per_row(valid_len, lead, q.device).reshape(-1),
        return_lse=return_lse)
    if not return_lse:
        return out.reshape(*lead, *out.shape[-3:])
    out, lse = out
    return (out.reshape(*lead, *out.shape[-3:]),
            lse.reshape(*lead, *lse.shape[-2:]))


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              q_offset: Offsets = 0, prefix_len: int = 0,
                              scale: Optional[float] = None,
                              valid_len: Optional[Offsets] = None):
    """The backward's plain version over any leading dims (the forward's
    layout; ``lse (..., Tq, H)``): :func:`.ref.flash_attention_bwd_ref`."""
    lead = q.shape[:-3]
    if valid_len is None:
        valid_len = k.shape[-3]

    def flat(t):
        return t.reshape(-1, *t.shape[len(lead):])

    dq, dk, dv = flash_attention_bwd_ref(
        flat(q), flat(k), flat(v), flat(o), flat(do), flat(lse),
        causal=causal,
        q_offset=_per_row(q_offset, lead, q.device).reshape(-1),
        prefix_len=prefix_len, scale=scale,
        valid_len=_per_row(valid_len, lead, q.device).reshape(-1))
    return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape))


def flash_attention_split_plain(q, k, v, splits: int, *, causal: bool = True,
                                q_offset: Offsets = 0, prefix_len: int = 0,
                                scale: Optional[float] = None,
                                valid_len: Optional[Offsets] = None
                                ) -> torch.Tensor:
    """The key split of the tensor-core route, in plain torch: each query
    row's visible keys ``[0, kend)`` cut into ``splits`` runs of whole
    64-key tiles (:func:`..plan.key_split_tiles`), one partial state per run
    (:func:`..ring_attention.kernel.stripe_state`), merged in split order
    with ``merge_states`` and normalized.  ``q (B, Tq, H, D)``, ``k (B,
    Tk, KH, D)``, ``v (B, Tk, KH, Dv)``; the offsets are ints or ``(B,)``
    tensors.  Here ``kend`` is the whole valid length (rows of one tile
    share it), so a run's keys past a row's causal frontier are masked."""
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qo = torch.as_tensor(q_offset, dtype=torch.int64, device=dev).expand(B)
    vl = torch.as_tensor(Tk if valid_len is None else valid_len,
                         dtype=torch.int64, device=dev).expand(B)
    qg = (q.float() * scale).reshape(B, Tq, KH, H // KH, D)
    q_pos = qo[:, None] + torch.arange(Tq, device=dev)
    out = []
    for b in range(B):
        kend = int(min(vl[b], Tk))
        state = None
        for lo, hi in key_split_tiles(-(-kend // FLASH_BQ), splits):
            lo, hi = lo * FLASH_BQ, min(hi * FLASH_BQ, kend)
            if hi <= lo:                  # an empty run: the identity
                part = empty_state(qg[b], v.shape[-1])
            else:
                vis = stripe_mask(hi - lo, q_pos=q_pos[b], k_start=lo,
                                  causal=causal, valid_len=kend)
                if causal and prefix_len:
                    kp = lo + torch.arange(hi - lo, device=dev)
                    vis = vis | ((kp < prefix_len)
                                 & (q_pos[b][:, None] < prefix_len))
                part = stripe_state(qg[b], k[b, lo:hi].float(),
                                    v[b, lo:hi].float(), vis)
            state = part if state is None else merge_states(state, part)
        out.append(finalize_state(state, q.dtype))
    return torch.stack(out)


def flash_combine_plain(m, l, acc, dtype) -> torch.Tensor:
    """The combine's plain version: per-split partial states ``m, l (N, S,
    Tq, H)``, ``acc (N, S, Tq, H, Dv)`` (f32) merged in split order with
    ``merge_states`` and normalized (``finalize_state``) to ``(N, Tq, H,
    Dv)`` in ``dtype``."""
    state = (m[:, 0], l[:, 0], acc[:, 0])
    for s in range(1, m.shape[1]):
        state = merge_states(state, (m[:, s], l[:, s], acc[:, s]))
    m_, l_, a_ = state
    return finalize_state((m_[..., None], l_[..., None], a_[..., None, :]),
                          dtype)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _combine(pm, pl, pacc, out, R, B, strides, dtype):
    """Launch the combine kernel on partials ``(R B, S, Tq, H[, Dv])`` into
    ``out`` (``strides``: its (r, b, t, h) element strides); counted in
    ``flash_attention_kernel.combine_launches``."""
    _, S, Tq, H, Dv = pacc.shape
    status = library("flash_attention").repro_flash_combine(
        pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
        *strides, R, B, Tq, H, Dv, S, DTYPE_CODES[dtype],
        stream_handle(out.device))
    flash_attention_kernel.combine_launches += 1
    check_launch(status, "flash attention combine")


def flash_combine_kernel(m, l, acc, dtype) -> torch.Tensor:
    """The split combine of the tensor-core route on its own: ``m, l (N, S,
    Tq, H)``, ``acc (N, S, Tq, H, Dv)`` contiguous f32 partial states ->
    ``(N, Tq, H, Dv)`` in ``dtype``.  On the card it launches the combine
    kernel; on CPU tensors it is :func:`flash_combine_plain`."""
    if not m.is_cuda:
        return flash_combine_plain(m, l, acc, dtype)
    if not (m.dtype == l.dtype == acc.dtype == torch.float32) \
            or dtype not in DTYPE_CODES \
            or not all(t.is_contiguous() for t in (m, l, acc)):
        raise TypeError("flash combine takes contiguous f32 partials")
    N, _, Tq, H, Dv = acc.shape
    out = torch.empty(N, Tq, H, Dv, dtype=dtype, device=m.device)
    _combine(m, l, acc, out, 1, N, (0, *out.stride()[:3]), dtype)
    return out


def _rank_batch(t: torch.Tensor, what: str):
    """``t (..., B, T, H, D)`` as (R, B, T, H, D) strides without a copy:
    every dim before B is folded into R."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash attention: {what} needs a unit last stride")
    lead = t.shape[:-4]
    try:
        r = t.view(-1, *t.shape[-4:]) if lead else t.unsqueeze(0)
    except RuntimeError:
        raise ValueError(
            f"flash attention: {what} of shape {tuple(t.shape)} and strides "
            f"{t.stride()} cannot fold its rank dims without a copy") from None
    return r.stride()[:4]


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           q_offset: Offsets = 0, prefix_len: int = 0,
                           scale: Optional[float] = None,
                           block: Optional[int] = None,
                           valid_len: Optional[Offsets] = None,
                           return_lse: bool = False):
    """GQA flash attention: ``q (..., B, Tq, H, D)``, ``k (..., B, Tk, KH,
    D)``, ``v (..., B, Tk, KH, Dv)`` -> ``(..., B, Tq, H, Dv)``.

    The leading dims (ranks, then the batch) must agree; each operand may be
    a strided view (a layer of a stacked cache).  ``q_offset`` and
    ``valid_len`` are ints or int tensors that broadcast to the leading
    dims; on the card they stay there (per-slot decode positions are never
    read back).  ``valid_len`` must not exceed Tk.  The key tile is the
    planner's ``plan_attention_block`` (at most ``block`` off the
    tensor-core route).  On the card q, k and v must share one dtype; the
    route is :func:`..plan.attention_route`'s, and the tensor-core route
    splits a tile's keys over :func:`..plan.plan_key_splits` blocks.
    With ``return_lse`` it returns ``(out, lse)``, the rows' log-sum-exp
    ``(..., B, Tq, H)`` f32 written by either route, and takes no key split.
    """
    lead = q.shape[:-3]
    Tq, H, D = q.shape[-3:]
    Tk, KH, Dk = k.shape[-3:]
    Dv = v.shape[-1]
    if k.shape[:-3] != lead or v.shape[:-1] != k.shape[:-1] or Dk != D \
            or H % KH:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, prefix_len=prefix_len,
                                     scale=scale, block=block,
                                     valid_len=valid_len,
                                     return_lse=return_lse)
    if q.dtype not in DTYPE_CODES or not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"flash attention kernel takes one of f32/f16/bf16 "
                        f"for q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash attention: q, k and v on different devices")
    if len(lead) < 1:
        raise ValueError("flash attention needs a batch dim")
    out = torch.empty(*lead, Tq, H, Dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(*lead, Tq, H, dtype=torch.float32, device=q.device) \
        if return_lse else None
    if min(Tq, Tk, H) == 0:
        out.zero_()
        return (out, lse.fill_(float("inf"))) if return_lse else out
    B = lead[-1]
    R = math.prod(lead) // B
    if valid_len is None:
        valid_len = Tk
    qo = _per_row(q_offset, lead, q.device).contiguous()
    vl = _per_row(valid_len, lead, q.device).contiguous()
    tile = _key_tile(q, k, v, block)
    qs, ks, vs, os_ = (_rank_batch(t, n) for t, n in
                       ((q, "q"), (k, "k"), (v, "v"), (out, "out")))
    # TMA reads q, k and v: their pointers and the byte strides of their
    # (r, b, t, h) dims longer than 1
    tma = [t.data_ptr() for t in (q, k, v)] + [
        st * q.element_size()
        for t, st4 in ((q, qs), (k, ks), (v, vs))
        for st, n in zip(st4, (R, B, t.shape[-3], t.shape[-2])) if n > 1]
    G = H // KH
    route = attention_route(q.dtype, D, Dv, G, *tma)
    splits = 1
    tiles = -(-Tq * G // FLASH_BQ)                # query tiles of a kv head
    if route == "wgmma" and not return_lse:
        splits = plan_key_splits(tiles * KH * R * B, Tk,
                                 sms=_sms(q.device.index or 0))
    scratch = (None, None, None)
    if splits > 1:
        pm = torch.empty(R * B, splits, Tq, H, dtype=torch.float32,
                         device=q.device)
        scratch = (pm, torch.empty_like(pm),
                   torch.empty(R * B, splits, Tq, H, Dv, dtype=torch.float32,
                               device=q.device))
    status = library("flash_attention").repro_flash_attention(
        q.data_ptr(), *qs, k.data_ptr(), *ks, v.data_ptr(), *vs,
        out.data_ptr(), *os_, qo.data_ptr(), vl.data_ptr(),
        R, B, Tq, Tk, H, KH, D, Dv, tile, int(causal), int(prefix_len),
        float(D ** -0.5 if scale is None else scale), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], splits,
        *(0 if t is None else t.data_ptr() for t in scratch),
        0 if lse is None else lse.data_ptr(), stream_handle(q.device))
    flash_attention_kernel.launches += 1
    flash_attention_kernel.route_launches[route] += 1
    flash_attention_kernel.last_grid = {
        "route": route, "splits": splits,
        "blocks": tiles * splits * KH * R * B}
    check_launch(status, "flash attention")
    if splits > 1:
        _combine(*scratch, out, R, B, os_, q.dtype)
    return (out, lse) if return_lse else out


flash_attention_kernel.launches = 0
flash_attention_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
flash_attention_kernel.combine_launches = 0
flash_attention_kernel.last_grid = None


def flash_attention_bwd_kernel(q, k, v, o, do, lse, *, causal: bool = True,
                               q_offset: Offsets = 0, prefix_len: int = 0,
                               scale: Optional[float] = None,
                               valid_len: Optional[Offsets] = None):
    """The gradient of :func:`flash_attention_kernel`: ``(dq, dk, dv)`` of
    its output from ``do``, given the forward's ``o`` and ``lse``, in the
    forward's layout (leading dims ranks, then the batch).  On the card it
    launches ``csrc/flash_attention_bwd.cu`` on contiguous copies of the
    operands, on the route :func:`..plan.attention_bwd_route` picks (its
    rows, dk/dv and dq passes on the tensor cores, or its delta, dk/dv and
    dq passes on the CUDA cores; one count in
    ``flash_attention_bwd_kernel.launches`` and one in ``.route_launches``
    of the route); on CPU tensors it is :func:`flash_attention_bwd_plain`."""
    lead = q.shape[:-3]
    Tq, H, D = q.shape[-3:]
    Tk, KH, _ = k.shape[-3:]
    Dv = v.shape[-1]
    if not q.is_cuda:
        return flash_attention_bwd_plain(
            q, k, v, o, do, lse, causal=causal, q_offset=q_offset,
            prefix_len=prefix_len, scale=scale, valid_len=valid_len)
    if q.dtype not in DTYPE_CODES or not (
            k.dtype == v.dtype == o.dtype == do.dtype == q.dtype) \
            or lse.dtype != torch.float32:
        raise TypeError("flash attention backward takes q, k, v, o and do "
                        "of one of f32/f16/bf16 and an f32 lse")
    if len(lead) < 1 or k.shape[:-3] != lead or H % KH \
            or o.shape != (*lead, Tq, H, Dv) or do.shape != o.shape \
            or lse.shape != (*lead, Tq, H):
        raise ValueError(f"flash attention backward shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, o {tuple(o.shape)}")
    N = math.prod(lead)
    if valid_len is None:
        valid_len = Tk
    qo = _per_row(q_offset, lead, q.device).contiguous()
    vl = _per_row(valid_len, lead, q.device).contiguous()
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    G = H // KH
    # TMA reads q, k, v and do (each as (C, heads, T, N) with the byte
    # strides of its dims longer than 1), the rows pass o and do in 16-byte
    # vectors; the rows' stats come by bulk copy
    size = q.element_size()
    tma = [t.data_ptr() for t in (q, k, v, o, do)] + [
        st * size for t in (q, k, v, do)
        for st, n in zip(t.stride()[-2::-1], (t.shape[-2], t.shape[-3], N))
        if n > 1]
    route = attention_bwd_route(q.dtype, D, Dv, G, *tma)
    tiles = -(-Tq * G // FLASH_BQ)            # query tiles of a kv head
    if route == "wgmma":
        # the rows pass's lse log2(e), delta and key end, rows padded to
        # the tile
        delta = torch.empty(3, N, KH, tiles * FLASH_BQ, dtype=torch.float32,
                            device=q.device)
    else:
        delta = torch.empty(N, Tq, H, dtype=torch.float32, device=q.device)
    status = library("flash_attention_bwd").repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), qo.data_ptr(), vl.data_ptr(), N, Tq,
        Tk, H, KH, D, Dv, int(causal), int(prefix_len),
        float(D ** -0.5 if scale is None else scale), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], stream_handle(q.device))
    flash_attention_bwd_kernel.launches += 1
    flash_attention_bwd_kernel.route_launches[route] += 1
    flash_attention_bwd_kernel.last_grid = {
        "route": route, "key_blocks": -(-Tk // FLASH_BQ) * KH * N,
        "query_blocks": tiles * KH * N}
    check_launch(status, "flash attention backward")
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
flash_attention_bwd_kernel.last_grid = None


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel (which also
    writes the rows' log-sum-exp, saved for the backward) and the backward
    kernel; on CPU tensors the plain versions of both."""

    @staticmethod
    def forward(fctx, q, k, v, causal, q_offset, prefix_len, scale, block):
        out, lse = flash_attention_kernel(
            q, k, v, causal=causal, q_offset=q_offset,
            prefix_len=prefix_len, scale=scale, block=block,
            return_lse=True)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.args = (causal, q_offset, prefix_len, scale)
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, out, lse = fctx.saved_tensors
        causal, q_offset, prefix_len, scale = fctx.args
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, do, lse, causal=causal, q_offset=q_offset,
            prefix_len=prefix_len, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_grad(q, k, v, *, causal: bool = True,
                         q_offset: Offsets = 0, prefix_len: int = 0,
                         scale: Optional[float] = None,
                         block: Optional[int] = None,
                         valid_len: Optional[Offsets] = None) -> torch.Tensor:
    """:class:`FlashAttention`, refusing what the model stack never trains
    through: a ``valid_len``, and a ``q_offset`` that differs from row to
    row of the batch (an int, or a tensor with one offset a rank and a
    batch dim of 1 as token-parallel attention gives it, is taken)."""
    if valid_len is not None:
        raise ValueError("flash attention with a gradient takes no "
                         "valid_len: the model stack trains on whole "
                         "sequences")
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() >= 1 \
            and q_offset.shape[-1] != 1:
        raise ValueError("flash attention with a gradient takes one "
                         "q_offset a rank (a batch dim of 1), not one a "
                         "row")
    return FlashAttention.apply(q, k, v, causal, q_offset, prefix_len,
                                scale, block)
