"""Fused sequence-parallel ring attention: one schedule, two executions.

K/V *stripes* rotate through the bidirectional ring as one-sided puts while
each rank folds the partial-softmax states (:mod:`.kernel`) of the stripes
it holds, so no rank ever holds the whole K/V.  Both executions run
:meth:`~repro_torch.kernels.plan.AttentionRingPlan.schedule` over stacked
ranks (``q (*mesh, B, tq, H, D)``, ``k/v (*mesh, B, tk, KH, D/Dv)``, the
ring being ``group``'s rank dim):

* :func:`fused_ring_attention_kernel` — the CUDA kernel
  (``csrc/ring_attention.cu``, which replaces ``fused_ring_attention_tpu``):
  every rank's ring in one cooperative launch, puts as stores into a
  device-memory slot buffer, the fence a grid barrier, offsets read from
  int32 device tensors, each stripe folded on the route
  :func:`..plan.attention_route` picks (counted per route in
  ``route_launches``);
* :func:`fused_ring_attention_interpret` — each put an ``ompx_put`` (a roll
  along the ring's rank dim) and each landing an ``ompx_fence``; the plain
  version of the kernel.

Every put is recorded against the RMATracker's attention windows
(:func:`repro_torch.core.rma.attention_window_names`) with the bytes the
OMPCCL communicator logs, by both executions alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.backends import group_rank, payload_bytes
from ...core.context import default_communicator, default_context
from ...core.groups import DiompGroup
from ...core.rma import attention_window_names, ompx_fence, ompx_put
from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import AttentionRingPlan, attention_route, default_planner
from .kernel import (empty_state, finalize_state, merge_states,
                     scaled_queries, stripe_mask, stripe_state)

__all__ = [
    "fused_ring_attention_interpret",
    "fused_ring_attention_kernel",
]


def _ring_slots(plan: AttentionRingPlan) -> int:
    """Slot count the kernel allocates: the plan's grant, floored at the
    reference's reuse-safe count (three per direction on the bidirectional
    ring, one per step on a one-way ring).  The grid barrier after every
    step would make two enough here."""
    steps = plan.exchange_steps
    need = min(steps + 1, 3) if plan.direction == "bidi" else steps + 1
    return max(plan.slots, need)


def _query_starts(q_offset, me: torch.Tensor, tq: int,
                  plan: AttentionRingPlan) -> torch.Tensor:
    """First global query position of every rank and batch row,
    ``(*mesh, B|1)``: ``q_offset`` plus the rank's own rows when the
    queries are sharded."""
    q0 = torch.as_tensor(q_offset, device=me.device)
    if plan.q_sharded:
        q0 = q0 + (me * tq).reshape(*me.shape, 1)
    return q0.expand(*torch.broadcast_shapes(q0.shape, (*me.shape, 1)))


def _land(tracker, win, *stripes):
    out = ompx_fence(*stripes)
    tracker.on_fence(win)
    tracker.on_read(win)
    return out


def fused_ring_attention_interpret(q, k, v, group: DiompGroup, *,
                                   plan: AttentionRingPlan,
                                   scale: Optional[float] = None,
                                   q_offset=0, valid_len=None):
    """Execute :meth:`AttentionRingPlan.schedule` with ``ompx_put`` as the
    remote copy.

    ``plan.overlap=True`` (the fused order): both directions' forwards
    start before the step's blocks and land after them; ``False`` is the
    serialized "host" listing — put, fence, then compute.  Stripes the
    plan's causal skip would drop are folded anyway: their states are the
    merge identity, so the result is the skipping kernel's bit for bit.
    ``q_offset`` and ``valid_len`` are ints or tensors that broadcast to
    ``(*mesh, B)``.
    """
    ctx = default_context()
    mesh = ctx.require_mesh()
    n = plan.n
    tq, D = q.shape[-3], q.shape[-1]
    tk, Dv = k.shape[-3], v.shape[-1]
    if scale is None:
        scale = D ** -0.5
    me = group_rank(group, mesh, q.device)
    q_pos = _query_starts(q_offset, me, tq, plan)[..., None] \
        + torch.arange(tq, device=q.device)
    B = q.shape[mesh.ndim]
    qg = scaled_queries(q, plan.kh, scale)
    state = empty_state(qg, Dv)

    def fold(state, k_str, v_str, src):
        vis = stripe_mask(tk, q_pos=q_pos, k_start=(src * tk)[..., None],
                          causal=plan.causal, valid_len=valid_len)
        vis = vis.expand(*mesh.sizes, B, tq, tk)
        return merge_states(state, stripe_state(qg, k_str, v_str, vis))

    if n == 1:
        return finalize_state(fold(state, k, v, me), q.dtype)

    tracker = ctx.rma
    cw_w, ccw_w = attention_window_names(group, n, plan.direction)
    nbytes = (payload_bytes(k, mesh.size), payload_bytes(v, mesh.size))

    def put(win, k_str, v_str, shift):
        tracker.ensure(win)
        for b in nbytes:
            tracker.on_put(win, b)
        return (ompx_put(k_str, group, shift=shift),
                ompx_put(v_str, group, shift=shift))

    kcw = kccw = k
    vcw = vccw = v
    for st in plan.schedule():
        s = st.index
        # forwards first: step s+1's stripes fly under this step's blocks
        kcw_n, vcw_n = put(cw_w[s], kcw, vcw, 1) if st.send_cw \
            else (kcw, vcw)
        kccw_n, vccw_n = put(ccw_w[s], kccw, vccw, -1) if st.send_ccw \
            else (kccw, vccw)
        if not plan.overlap:      # serialized listing: land, then compute
            if st.send_cw:
                kcw_n, vcw_n = _land(tracker, cw_w[s], kcw_n, vcw_n)
            if st.send_ccw:
                kccw_n, vccw_n = _land(tracker, ccw_w[s], kccw_n, vccw_n)
        if st.compute_cw:
            state = fold(state, kcw, vcw, (me - s) % n)
        if st.compute_ccw:
            state = fold(state, kccw, vccw, (me + s) % n)
        if plan.overlap:          # the next step's stripes must have landed
            if st.send_cw:
                kcw_n, vcw_n = _land(tracker, cw_w[s], kcw_n, vcw_n)
            if st.send_ccw:
                kccw_n, vccw_n = _land(tracker, ccw_w[s], kccw_n, vccw_n)
        kcw, vcw, kccw, vccw = kcw_n, vcw_n, kccw_n, vccw_n
    return finalize_state(state, q.dtype)


def _schedule_table(plan: AttentionRingPlan, device) -> torch.Tensor:
    """The schedule as the kernel's int32 table (one row per step: index,
    compute_cw, compute_ccw, send_cw, send_ccw)."""
    rows = [[st.index, st.compute_cw, st.compute_ccw, st.send_cw, st.send_ccw]
            for st in plan.schedule()]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _record_traffic(k, v, group: DiompGroup, plan: AttentionRingPlan):
    """Log the schedule's puts and landings as the emulation logs them (the
    OMPCCL call and byte logs and the RMATracker's windows)."""
    if plan.n == 1:
        return
    ctx = default_context()
    comm = default_communicator(group)
    tracker = ctx.rma
    nbytes = (payload_bytes(k, ctx.require_mesh().size),
              payload_bytes(v, ctx.require_mesh().size))
    cw_w, ccw_w = attention_window_names(group, plan.n, plan.direction)
    for st in plan.schedule():
        for sent, wins in ((st.send_cw, cw_w), (st.send_ccw, ccw_w)):
            if sent:
                tracker.ensure(wins[st.index])
                for b, x in zip(nbytes, (k, v)):
                    tracker.on_put(wins[st.index], b)
                    comm.record("put", x)
                tracker.on_fence(wins[st.index])
                tracker.on_read(wins[st.index])


def fused_ring_attention_kernel(q, k, v, group: DiompGroup, *,
                                plan: AttentionRingPlan,
                                scale: Optional[float] = None,
                                q_offset=0, valid_len=None):
    """The whole ring of every rank in one launch of
    ``csrc/ring_attention.cu`` (counted in ``.launches``); on CPU tensors,
    the plain version (:func:`fused_ring_attention_interpret`).

    ``q (*mesh, B, tq, H, D)``, ``k (*mesh, B, tk, KH, D)``, ``v (*mesh, B,
    tk, KH, Dv)`` share one dtype; ``q_offset`` and ``valid_len`` are ints
    or int tensors that broadcast to ``(*mesh, B)`` and stay on the card.
    The ring is ``group``'s rank dim; the other mesh dims are independent
    rings.
    """
    if not q.is_cuda:
        return fused_ring_attention_interpret(
            q, k, v, group, plan=plan, scale=scale, q_offset=q_offset,
            valid_len=valid_len)
    mesh = default_context().require_mesh()
    nd = mesh.ndim
    n = plan.n
    B, tq, H, D = q.shape[nd:]
    tk, KH, Dk = k.shape[nd + 1:]
    Dv = v.shape[-1]
    if len(group.axes) != 1 or group.axis_size(mesh) != n:
        raise ValueError(f"plan for a ring of {n} on group {group.axes}")
    if k.shape[:nd + 1] != q.shape[:nd + 1] or v.shape[:-1] != k.shape[:-1] \
            or Dk != D or H % KH or KH != plan.kh:
        raise ValueError(f"ring attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or not k.dtype == v.dtype == q.dtype \
            or not k.device == v.device == q.device:
        raise TypeError(f"ring attention kernel takes one f32/f16/bf16 dtype "
                        f"on one device, got {q.dtype}, {k.dtype}, {v.dtype}")
    tile = default_planner().plan_attention_block(tq, tk, D, Dv, q.dtype,
                                                  block=plan.block)
    _record_traffic(k, v, group, plan)

    # kernel layout: the ring's rank dim last of the mesh dims, the others
    # folded into independent rings
    ring = group.rank_dims(mesh)[0]
    rings = mesh.size // n

    def ring_last(t):
        return t.movedim(ring, nd - 1).contiguous()

    me = group_rank(group, mesh, q.device)
    q0 = _query_starts(q_offset, me, tq, plan).expand(*mesh.sizes, B)
    vl = torch.as_tensor(n * tk if valid_len is None else valid_len,
                         device=q.device).expand(*mesh.sizes, B)
    q0, vl = (ring_last(t.to(torch.int32)) for t in (q0, vl))
    kq, kk, kv = (ring_last(t) for t in (q, k, v))
    slots = _ring_slots(plan)
    bufk = torch.empty(rings, n, 2, slots, *kk.shape[nd:], dtype=q.dtype,
                       device=q.device)
    bufv = torch.empty(rings, n, 2, slots, *kv.shape[nd:], dtype=q.dtype,
                       device=q.device)
    rows = rings * n * B * KH * tq * (H // KH)
    cm = torch.empty(rows, dtype=torch.float32, device=q.device)
    cl = torch.empty_like(cm)
    cacc = torch.empty(rows, Dv, dtype=torch.float32, device=q.device)
    sched = _schedule_table(plan, q.device)
    out = torch.empty(*kq.shape[:-1], Dv, dtype=q.dtype, device=q.device)
    # TMA reads the queries and the slots (contiguous; their other byte
    # strides are multiples of these)
    item = q.element_size()
    route = attention_route(q.dtype, D, Dv, H // KH, kq.data_ptr(),
                            bufk.data_ptr(), bufv.data_ptr(), H * D * item,
                            KH * D * item, KH * Dv * item)
    status = library("ring_attention").repro_ring_attention(
        kq.data_ptr(), kk.data_ptr(), kv.data_ptr(), out.data_ptr(),
        bufk.data_ptr(), bufv.data_ptr(), cm.data_ptr(), cl.data_ptr(),
        cacc.data_ptr(), sched.data_ptr(), sched.shape[0], q0.data_ptr(),
        vl.data_ptr(), rings, n, slots, B, tq, tk, H, KH, D, Dv, tile,
        int(plan.causal), float(D ** -0.5 if scale is None else scale),
        DTYPE_CODES[q.dtype], ROUTE_CODES[route], stream_handle(q.device))
    fused_ring_attention_kernel.launches += 1
    fused_ring_attention_kernel.route_launches[route] += 1
    check_launch(status, "fused_ring_attention")
    return out.movedim(nd - 1, ring)


fused_ring_attention_kernel.launches = 0
fused_ring_attention_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
