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

The gradient (the reference differentiates its emulation, whose whole
schedule carries a hand-written VJP; its TPU kernel has none): on CPU
tensors the emulation carries the same VJP (:func:`_ring_grads`, the plain
version of the gradient kernel), which logs nothing; on the card
:class:`RingAttentionFn` runs the ring kernel with the rows' log-sum-exp,
then the gradient kernel :func:`fused_ring_attention_bwd_kernel`
(``csrc/ring_attention_bwd.cu``) on the forward's schedule.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from ...core.backends import group_rank, payload_bytes
from ...core.context import default_communicator, default_context
from ...core.groups import DiompGroup
from ...core.rma import attention_window_names, ompx_fence, ompx_put
from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import (AttentionRingPlan, attention_bwd_route, attention_route,
                    default_planner)
from .kernel import (chain_grads, custom_vjp, empty_state, finalize_state,
                     merge_states, scaled_queries, stripe_mask, stripe_state)

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


def _fold_masks(q_offset, valid_len, me: torch.Tensor, tq: int, tk: int,
                B: int, mesh, plan: AttentionRingPlan):
    """Each fold's visibility ``(*mesh, B, tq, tk)``, in fold order: rank
    ``me``'s queries against the stripe its ``i``-th fold receives."""
    q_pos = _query_starts(q_offset, me, tq, plan)[..., None] \
        + torch.arange(tq, device=me.device)
    masks = []
    for dirn, s in plan.fold_steps():
        src = (me - s) % plan.n if dirn == "cw" else (me + s) % plan.n
        vis = stripe_mask(tk, q_pos=q_pos, k_start=(src * tk)[..., None],
                          causal=plan.causal, valid_len=valid_len)
        masks.append(vis.expand(*mesh.sizes, B, tq, tk))
    return masks


def _canonical_folds(plan: AttentionRingPlan) -> List[int]:
    """The fold indices in the order an owner sums its stripe's cotangents:
    its own stripe, then the clockwise deliveries by ascending step, then
    the counter-clockwise ones."""
    folds = plan.fold_steps()
    return [folds.index(("cw", 0))] + [
        i for want in ("cw", "ccw") for i, (dirn, s) in enumerate(folds)
        if dirn == want and s > 0]


def _ring_grads(q, k, v, ct, group: DiompGroup, mesh,
                plan: AttentionRingPlan, scale: float, masks):
    """The whole schedule's backward (the reference's ``ring_bwd``): replay
    the arrivals with plain rolls along the ring's rank dim (nothing logged:
    the forward's puts are the traffic), :func:`~.kernel.chain_grads` on
    every rank at once, then each stripe's cotangent rolled back to its
    owner and summed in the canonical order."""
    n, KH = plan.n, plan.kh
    D, Dv = q.shape[-1], v.shape[-1]
    d = group.rank_dims(mesh)[0]
    folds = plan.fold_steps()
    fidx = {f: i for i, f in enumerate(folds)}
    stripes = [None] * len(folds)
    kcw = kccw = k
    vcw = vccw = v
    for st in plan.schedule():
        s = st.index
        if st.compute_cw:
            i = fidx[("cw", s)]
            stripes[i] = (kcw, vcw, masks[i])
        if st.compute_ccw:
            i = fidx[("ccw", s)]
            stripes[i] = (kccw, vccw, masks[i])
        if st.send_cw:
            kcw, vcw = (torch.roll(t, 1, d) for t in (kcw, vcw))
        if st.send_ccw:
            kccw, vccw = (torch.roll(t, -1, d) for t in (kccw, vccw))
    ct32 = ct.float().reshape(*ct.shape[:-2], KH, -1, Dv)
    gqg, gks, gvs = chain_grads(scaled_queries(q, KH, scale), stripes, ct32)
    gq = (gqg.reshape(q.shape) * scale).to(q.dtype)
    order = _canonical_folds(plan)
    gk, gv = gks[order[0]], gvs[order[0]]
    for i in order[1:]:
        dirn, s = folds[i]
        back = -s if dirn == "cw" else s         # to the stripe's owner
        gk = gk + torch.roll(gks[i], back, d)
        gv = gv + torch.roll(gvs[i], back, d)
    return gq, gk.to(k.dtype), gv.to(v.dtype)


def fused_ring_attention_interpret(q, k, v, group: DiompGroup, *,
                                   plan: AttentionRingPlan,
                                   scale: Optional[float] = None,
                                   q_offset=0, valid_len=None,
                                   return_lse: bool = False):
    """Execute :meth:`AttentionRingPlan.schedule` with ``ompx_put`` as the
    remote copy.

    ``plan.overlap=True`` (the fused order): both directions' forwards
    start before the step's blocks and land after them; ``False`` is the
    serialized "host" listing — put, fence, then compute.  Stripes the
    plan's causal skip would drop are folded anyway: their states are the
    merge identity, so the result is the skipping kernel's bit for bit.
    ``q_offset`` and ``valid_len`` are ints or tensors that broadcast to
    ``(*mesh, B)``.

    The whole schedule carries a hand-written VJP (:func:`_ring_grads`,
    the plain version of the gradient kernel): its replay and return trip
    log nothing, so the communicator's and the tracker's books after a
    forward and a backward are the forward's.  With ``return_lse`` it
    returns ``(out, lse)`` without a gradient, ``lse (*mesh, B, tq, H)``
    the rows' log-sum-exp from the folded state (+inf on a row that saw no
    key), the plain version of the kernel's.
    """
    ctx = default_context()
    mesh = ctx.require_mesh()
    n = plan.n
    tq, D = q.shape[-3], q.shape[-1]
    tk, Dv = k.shape[-3], v.shape[-1]
    if scale is None:
        scale = D ** -0.5
    me = group_rank(group, mesh, q.device)
    masks = _fold_masks(q_offset, valid_len, me, tq, tk, q.shape[mesh.ndim],
                        mesh, plan)
    fidx = {f: i for i, f in enumerate(plan.fold_steps())}

    def fold_all(q, k, v):
        qg = scaled_queries(q, plan.kh, scale)
        state = empty_state(qg, Dv)

        def fold(state, k_str, v_str, i):
            return merge_states(state, stripe_state(qg, k_str, v_str,
                                                    masks[i]))

        if n == 1:
            return fold(state, k, v, 0)

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
                state = fold(state, kcw, vcw, fidx[("cw", s)])
            if st.compute_ccw:
                state = fold(state, kccw, vccw, fidx[("ccw", s)])
            if plan.overlap:          # the next step's stripes must have landed
                if st.send_cw:
                    kcw_n, vcw_n = _land(tracker, cw_w[s], kcw_n, vcw_n)
                if st.send_ccw:
                    kccw_n, vccw_n = _land(tracker, ccw_w[s], kccw_n, vccw_n)
            kcw, vcw, kccw, vccw = kcw_n, vcw_n, kccw_n, vccw_n
        return state

    def run(q, k, v):
        return finalize_state(fold_all(q, k, v), q.dtype)

    def grads(q, k, v, ct):
        return _ring_grads(q, k, v, ct, group, mesh, plan, scale, masks)

    if return_lse:
        with torch.no_grad():
            m, l, acc = fold_all(q, k, v)
        lse = torch.where(l > 0, m + torch.log(l), float("inf"))
        return (finalize_state((m, l, acc), q.dtype),
                lse.flatten(-2, -1))
    return custom_vjp(run, grads, q, k, v)


def fused_ring_attention_bwd_plain(q, k, v, do, group: DiompGroup, *,
                                   plan: AttentionRingPlan,
                                   scale: Optional[float] = None,
                                   q_offset=0, valid_len=None, mesh=None):
    """The gradient kernel's plain version: ``(dq, dk, dv)`` of the ring's
    output from ``do`` by the emulation's hand-written backward (the chain
    form, :func:`_ring_grads`), in the forward's layout.  ``mesh`` defaults
    to the active context's."""
    mesh = mesh or default_context().require_mesh()
    D = q.shape[-1]
    me = group_rank(group, mesh, q.device)
    masks = _fold_masks(q_offset, valid_len, me, q.shape[-3], k.shape[-3],
                        q.shape[mesh.ndim], mesh, plan)
    return _ring_grads(q, k, v, do, group, mesh, plan,
                       D ** -0.5 if scale is None else scale, masks)


def _schedule_table(plan: AttentionRingPlan, device) -> torch.Tensor:
    """The schedule as the kernel's int32 table (one row per step: index,
    compute_cw, compute_ccw, send_cw, send_ccw)."""
    rows = [[st.index, st.compute_cw, st.compute_ccw, st.send_cw, st.send_ccw]
            for st in plan.schedule()]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _step_work(plan: AttentionRingPlan, st, rings: int, B: int, tq: int,
               tk: int, KH: int, G: int, bk: int) -> np.ndarray:
    """The work of each item of the gradient kernel's step ``st``, in the
    kernel's item order (``csrc/ring_attention_bwd.cu``: the dk/dv items,
    (live direction, sequence, kv head, key tile of ``bk`` keys), then the
    dq items, (sequence, kv head, 64-row query tile)): a dk/dv item's count
    of query tiles that see its keys (``ring_kv_item``'s ``ntiles``), a dq
    item's count of key tiles its rows see over the step's stripes
    (``ring_q_item``'s ``nt[0] + nt[1]``).  Counted from the plan and the
    shapes alone: the plan's ``q_offset`` (0 where it is None) and
    ``valid_len`` (``n tk`` where it is None), never the call's tensors."""
    n, rows = plan.n, tq * G
    qtiles, ktiles = -(-rows // 64), -(-tk // bk)
    vlen = n * tk if plan.valid_len is None else min(plan.valid_len, n * tk)
    r = np.arange(rings * n * B) // B % n             # each sequence's rank
    q0 = (plan.q_offset or 0) + r * (tq if plan.q_sharded else 0)
    dirs = [d for d, on in ((0, st.compute_cw), (1, st.compute_ccw)) if on]
    srcs = [(r - st.index) % n if d == 0 else (r + st.index) % n
            for d in dirs]
    kv = []
    k0 = np.arange(ktiles) * bk
    for src in srcs:
        kbase = (src * tk)[:, None]
        klim = np.clip(np.minimum(tk, vlen - kbase), 0, None)
        row0 = np.maximum(kbase + k0 - q0[:, None], 0) * G // 64 * 64 \
            if plan.causal else np.zeros_like(kbase + k0)
        ntiles = np.where(k0 < klim, np.maximum(-(-(rows - row0) // 64), 0),
                          0)
        kv.append(np.broadcast_to(ntiles[:, None, :], (len(q0), KH, ktiles)))
    i0 = np.arange(qtiles) * 64
    if plan.causal:
        t_last = (np.minimum(i0 + 64, rows) - 1) // G
        kend = np.minimum(vlen, q0[:, None] + t_last + 1)
    else:
        kend = np.full((len(q0), qtiles), vlen)
    nt = np.zeros_like(kend)
    for src in srcs:
        kbase = (src * tk)[:, None]
        klim = np.clip(np.minimum(tk, vlen - kbase), 0, None)
        nt = nt + -(-np.clip(np.minimum(klim, kend - kbase), 0, None) // bk)
    dq = np.broadcast_to(nt[:, None, :], (len(q0), KH, qtiles))
    return np.concatenate([w.ravel() for w in (*kv, dq)])


@functools.lru_cache(maxsize=64)
def _item_order(plan: AttentionRingPlan, rings: int, B: int, tq: int,
                tk: int, KH: int, G: int, bk: int) -> torch.Tensor:
    """The gradient kernel's deal: each step's items, heaviest first by
    :func:`_step_work` (ties in item order), one permutation a step of the
    schedule, concatenated, int32 on the host.  The kernel deals each
    step's order to its cooperative grid a round at a time, each round in
    the direction the last did not take, so each step's heaviest items
    start first and the light ones fill in behind them; the order changes
    no item's arithmetic."""
    return torch.from_numpy(np.concatenate([
        np.argsort(-_step_work(plan, st, rings, B, tq, tk, KH, G, bk),
                   kind="stable")
        for st in plan.schedule()]).astype(np.int32))


def _record_traffic(k, v, group: DiompGroup, plan: AttentionRingPlan):
    """Log the schedule's puts and landings as the emulation logs them (the
    OMPCCL call and byte logs, the fault plan's rolls and retries, and the
    RMATracker's windows)."""
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
                    comm.kernel_put(x)
                tracker.on_fence(wins[st.index])
                tracker.on_read(wins[st.index])


def fused_ring_attention_kernel(q, k, v, group: DiompGroup, *,
                                plan: AttentionRingPlan,
                                scale: Optional[float] = None,
                                q_offset=0, valid_len=None,
                                return_lse: bool = False):
    """The whole ring of every rank in one launch of
    ``csrc/ring_attention.cu`` (counted in ``.launches``); on CPU tensors,
    the plain version (:func:`fused_ring_attention_interpret`).

    ``q (*mesh, B, tq, H, D)``, ``k (*mesh, B, tk, KH, D)``, ``v (*mesh, B,
    tk, KH, Dv)`` share one dtype; ``q_offset`` and ``valid_len`` are ints
    or int tensors that broadcast to ``(*mesh, B)`` and stay on the card.
    The ring is ``group``'s rank dim; the other mesh dims are independent
    rings.  Where a gradient is wanted it goes through
    :class:`RingAttentionFn`, whose backward is the gradient kernel.  With
    ``return_lse`` it returns ``(out, lse)`` without a gradient, the rows'
    log-sum-exp ``(*mesh, B, tq, H)`` f32 (+inf on a row that sees no key).
    """
    if not q.is_cuda:
        return fused_ring_attention_interpret(
            q, k, v, group, plan=plan, scale=scale, q_offset=q_offset,
            valid_len=valid_len, return_lse=return_lse)
    if return_lse:
        with torch.no_grad():
            return _ring_forward(q, k, v, group, plan, scale, q_offset,
                                 valid_len, with_lse=True)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingAttentionFn.apply(q, k, v, group, plan, scale, q_offset,
                                     valid_len)
    return _ring_forward(q, k, v, group, plan, scale, q_offset, valid_len,
                         with_lse=False)


def _ring_layout(q, k, group: DiompGroup, plan: AttentionRingPlan, mesh,
                 q_offset, valid_len):
    """The kernels' layout: the ring's rank dim last of the mesh dims (the
    others folded into independent rings), a tensor moved there by the
    returned ``ring_last``, and each (ring, rank, b)'s int32 query start and
    valid length."""
    nd = mesh.ndim
    ring = group.rank_dims(mesh)[0]
    B, tq = q.shape[nd], q.shape[nd + 1]

    def ring_last(t):
        return t.movedim(ring, nd - 1).contiguous()

    me = group_rank(group, mesh, q.device)
    q0 = _query_starts(q_offset, me, tq, plan).expand(*mesh.sizes, B)
    vl = torch.as_tensor(plan.n * k.shape[nd + 1] if valid_len is None
                         else valid_len, device=q.device).expand(
                             *mesh.sizes, B)
    return ring, ring_last, ring_last(q0.to(torch.int32)), \
        ring_last(vl.to(torch.int32))


def _check_ring_operands(q, k, v, group, plan, mesh, what, *more):
    nd = mesh.ndim
    n = plan.n
    H, D = q.shape[nd + 2:]
    KH, Dk = k.shape[nd + 2:]
    if len(group.axes) != 1 or group.axis_size(mesh) != n:
        raise ValueError(f"plan for a ring of {n} on group {group.axes}")
    if k.shape[:nd + 1] != q.shape[:nd + 1] or v.shape[:-1] != k.shape[:-1] \
            or Dk != D or H % KH or KH != plan.kh:
        raise ValueError(f"{what} shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES \
            or any(t.dtype != q.dtype for t in (k, v, *more)) \
            or any(t.device != q.device for t in (k, v, *more)):
        raise TypeError(f"{what} takes one f32/f16/bf16 dtype on one device, "
                        f"got {[str(t.dtype) for t in (q, k, v, *more)]}")


def _ring_forward(q, k, v, group: DiompGroup, plan: AttentionRingPlan,
                  scale, q_offset, valid_len, with_lse: bool):
    """One launch of ``csrc/ring_attention.cu``; with ``with_lse`` also the
    rows' log-sum-exp ``(*mesh, B, tq, H)`` f32 (+inf on a row that sees no
    key)."""
    mesh = default_context().require_mesh()
    nd = mesh.ndim
    n = plan.n
    _check_ring_operands(q, k, v, group, plan, mesh, "ring attention kernel")
    B, tq, H, D = q.shape[nd:]
    tk, KH = k.shape[nd + 1:nd + 3]
    Dv = v.shape[-1]
    tile = default_planner().plan_attention_block(tq, tk, D, Dv, q.dtype,
                                                  block=plan.block)
    _record_traffic(k, v, group, plan)
    ring, ring_last, q0, vl = _ring_layout(q, k, group, plan, mesh, q_offset,
                                           valid_len)
    rings = mesh.size // n
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
    lse = torch.empty(kq.shape[:-1], dtype=torch.float32, device=q.device) \
        if with_lse else None
    # TMA reads the queries and the slots (contiguous; their other byte
    # strides are multiples of these)
    item = q.element_size()
    route = attention_route(q.dtype, D, Dv, H // KH, kq.data_ptr(),
                            bufk.data_ptr(), bufv.data_ptr(), H * D * item,
                            KH * D * item, KH * Dv * item)
    status = library("ring_attention").repro_ring_attention(
        kq.data_ptr(), kk.data_ptr(), kv.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), bufk.data_ptr(),
        bufv.data_ptr(), cm.data_ptr(), cl.data_ptr(), cacc.data_ptr(),
        sched.data_ptr(), sched.shape[0], q0.data_ptr(), vl.data_ptr(),
        rings, n, slots, B, tq, tk, H, KH, D, Dv, tile, int(plan.causal),
        float(D ** -0.5 if scale is None else scale), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], stream_handle(q.device))
    fused_ring_attention_kernel.launches += 1
    fused_ring_attention_kernel.route_launches[route] += 1
    check_launch(status, "fused_ring_attention")
    out = out.movedim(nd - 1, ring)
    return (out, lse.movedim(nd - 1, ring)) if with_lse else out


fused_ring_attention_kernel.launches = 0
fused_ring_attention_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)


class RingAttentionFn(torch.autograd.Function):
    """Ring attention with a gradient, on the card only: the forward is the
    ring kernel with the rows' log-sum-exp (saved for the backward), the
    backward the gradient kernel (:func:`fused_ring_attention_bwd_kernel`).
    CPU tensors are refused: their gradient is the emulation's own
    (:func:`fused_ring_attention_interpret`).  The forward's mesh is kept
    for the backward, which the autograd engine runs in a thread of its own
    where the caller's context is not seen."""

    @staticmethod
    def forward(fctx, q, k, v, group, plan, scale, q_offset, valid_len):
        if not q.is_cuda:
            raise ValueError("RingAttentionFn runs on the card; on CPU "
                             "tensors the emulation carries the gradient")
        out, lse = _ring_forward(q, k, v, group, plan, scale, q_offset,
                                 valid_len, with_lse=True)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.args = (group, plan, scale, q_offset, valid_len,
                     default_context().require_mesh())
        return out

    @staticmethod
    def backward(fctx, do):
        q, k, v, out, lse = fctx.saved_tensors
        group, plan, scale, q_offset, valid_len, mesh = fctx.args
        dq, dk, dv = fused_ring_attention_bwd_kernel(
            q, k, v, out, do, lse, group, plan=plan, scale=scale,
            q_offset=q_offset, valid_len=valid_len, mesh=mesh)
        return dq, dk, dv, None, None, None, None, None


def ring_bwd_route(dtype, d: int, dv: int, g: int,
                   *ptrs_and_strides: int) -> str:
    """The route a launch of the ring's gradient takes in
    ``csrc/ring_attention_bwd.cu``: row 10's rule
    (:func:`..plan.attention_bwd_route`) without its wide instance —
    ``"wgmma"`` (TMA and the tensor cores) for 16-bit operands with D and Dv
    multiples of 16 in [16, 128], or D = Dv = 256 (paligemma-3b's heads,
    the 256-wide instance), G dividing 64 and 16-byte-aligned pointers and
    strides; ``"simt"`` (the CUDA cores) otherwise: f32, MLA's D = 192 and
    a width of 256 beside another among them."""
    if d == 192:
        return "simt"
    return attention_bwd_route(dtype, d, dv, g, *ptrs_and_strides)


def fused_ring_attention_bwd_kernel(q, k, v, o, do, lse, group: DiompGroup,
                                    *, plan: AttentionRingPlan,
                                    scale: Optional[float] = None,
                                    q_offset=0, valid_len=None, mesh=None):
    """The gradient of the ring: ``(dq, dk, dv)`` of its output ``o`` from
    ``do``, given the rows' log-sum-exp ``lse (*mesh, B, tq, H)`` f32, in
    the forward's layout, by one launch of ``csrc/ring_attention_bwd.cu``
    (counted in ``.launches`` and ``.route_launches``): the stripes rotate
    on the forward's schedule, each rank's dq sums in fold order and each
    stripe's dk / dv come home to their owner, summed in the canonical
    order; each step's items are dealt heaviest first
    (:func:`_item_order`).  Each launch takes :func:`ring_bwd_route`'s
    route.  On CPU
    tensors it is the
    plain version, :func:`fused_ring_attention_bwd_plain` (``o`` and
    ``lse`` unused).  ``mesh`` defaults to the active context's."""
    mesh = mesh or default_context().require_mesh()
    if not q.is_cuda:
        return fused_ring_attention_bwd_plain(
            q, k, v, do, group, plan=plan, scale=scale, q_offset=q_offset,
            valid_len=valid_len, mesh=mesh)
    nd = mesh.ndim
    n = plan.n
    _check_ring_operands(q, k, v, group, plan, mesh,
                         "ring attention backward", o, do)
    B, tq, H, D = q.shape[nd:]
    tk, KH = k.shape[nd + 1:nd + 3]
    Dv = v.shape[-1]
    if o.shape != (*q.shape[:-1], Dv) or do.shape != o.shape \
            or lse.shape != q.shape[:-1] or lse.dtype != torch.float32:
        raise ValueError(f"ring attention backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} for q {tuple(q.shape)}")
    ring, ring_last, q0, vl = _ring_layout(q, k, group, plan, mesh, q_offset,
                                           valid_len)
    rings = mesh.size // n
    kq, kk, kv, ko, kdo, klse = (ring_last(t) for t in (q, k, v, o, do, lse))
    slots = _ring_slots(plan)
    folds = len(plan.fold_steps())
    f32 = dict(dtype=torch.float32, device=q.device)
    bufk = torch.empty(rings, n, 2, slots, *kk.shape[nd:], dtype=q.dtype,
                       device=q.device)
    bufv = torch.empty(rings, n, 2, slots, *kv.shape[nd:], dtype=q.dtype,
                       device=q.device)
    item = q.element_size()
    route = ring_bwd_route(q.dtype, D, Dv, H // KH, kq.data_ptr(),
                           bufk.data_ptr(), bufv.data_ptr(), kdo.data_ptr(),
                           H * D * item, KH * D * item, KH * Dv * item,
                           H * Dv * item)
    if route == "wgmma":
        # the rows pass's lse log2(e), delta and key end, rows padded to
        # the 64-row tile
        rp = -(-tq * (H // KH) // 64) * 64
        delta = torch.empty(3, rings * n * B * KH * rp, **f32)
    else:
        delta = torch.empty(klse.shape, **f32)
    dq_acc = torch.empty(kq.shape, **f32)
    part_k = torch.empty(rings, n, folds, *kk.shape[nd:], **f32)
    part_v = torch.empty(rings, n, folds, *kv.shape[nd:], **f32)
    dq, dk, dv = (torch.empty_like(t) for t in (kq, kk, kv))
    sched = _schedule_table(plan, q.device)
    # the items' key tile: 64 keys on the tensor cores, 64 or (above 128
    # columns) 32 on the CUDA cores
    bk = 64 if route == "wgmma" or max(D, Dv) <= 128 else 32
    order = _item_order(plan, rings, B, tq, tk, KH, H // KH, bk).to(
        q.device)
    canon = torch.tensor(_canonical_folds(plan), dtype=torch.int32,
                         device=q.device)
    status = library("ring_attention_bwd").repro_ring_attention_bwd(
        kq.data_ptr(), kk.data_ptr(), kv.data_ptr(), ko.data_ptr(),
        kdo.data_ptr(), klse.data_ptr(), delta.data_ptr(), bufk.data_ptr(),
        bufv.data_ptr(), dq_acc.data_ptr(), part_k.data_ptr(),
        part_v.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        sched.data_ptr(), sched.shape[0], order.data_ptr(),
        canon.data_ptr(), folds, q0.data_ptr(), vl.data_ptr(), rings, n,
        slots, B, tq, tk, H, KH, D, Dv, int(plan.causal),
        float(D ** -0.5 if scale is None else scale),
        DTYPE_CODES[q.dtype], ROUTE_CODES[route], stream_handle(q.device))
    fused_ring_attention_bwd_kernel.launches += 1
    fused_ring_attention_bwd_kernel.route_launches[route] += 1
    check_launch(status, "fused_ring_attention backward")
    return tuple(t.movedim(nd - 1, ring) for t in (dq, dk, dv))


fused_ring_attention_bwd_kernel.launches = 0
fused_ring_attention_bwd_kernel.route_launches = dict.fromkeys(ROUTE_CODES,
                                                               0)
