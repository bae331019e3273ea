"""Fused dropless MoE dispatch: one schedule, two executions.

Token→expert routing scatters rows into per-expert landing layouts whose
capacities are **asymmetric** — sized per expert from measured load by
:meth:`~repro_torch.kernels.plan.OverlapPlanner.plan_alltoall` — so the
dispatch is dropless by construction (``caps[e] >= load[e]``).  The
exchange is a ring of one-sided puts: step ``s`` puts the block for the
rank ``s + 1`` ahead, runs the expert GEMMs on the block that landed from
the rank ``s`` behind, and puts that result straight back to its source.
Every put is recorded on the OMPCCL byte log and on the RMATracker's MoE
dispatch/combine windows (:func:`repro_torch.core.rma.dispatch_window_names`)
with the same bytes.

Both executions run :meth:`~repro_torch.kernels.plan.AllToAllPlan.schedule`
over stacked ranks (``toks (*mesh, t_loc, d)``, my experts' weights
``(*mesh, E_loc, d, f)``):

* :func:`fused_moe_dispatch_kernel` — the CUDA kernel
  (``csrc/moe_dispatch.cu``, which replaces ``fused_moe_dispatch_tpu``):
  every rank's ring in one cooperative launch;
* :func:`fused_moe_dispatch_interpret` — each put an ``ompx_put`` (a roll
  along the EP group's rank dim), for any ``mlp`` and the CPU.

The routing scatter (:func:`dispatch_buffers`) and the gated combine stay
outside the kernel, in torch, as in the reference.

Gradients.  On the card the kernel's block-level function, wire blocks
``buf`` to landed results ``full`` (out block j of rank r is rank j's
experts on r's block j), runs under :class:`FusedDispatchFn`, whose backward
is one launch of ``csrc/moe_dispatch_bwd.cu`` (:func:`fused_dispatch_bwd_kernel`:
the same schedule, each put carrying the x and the cotangent blocks, each
return the dx block; every dW summed once all blocks have landed).  The
scatter and the combine stay torch ops under autograd.  On the CPU the
emulation is differentiated as it stands, with the expert MLP's plain
version; :func:`fused_dispatch_blocks_plain` and
:func:`fused_dispatch_bwd_plain` are the block-level function and its
gradient in plain PyTorch, the versions the kernels are held to.  The
backward records nothing on the put logs: the reference's AD
transposes its puts without running their Python.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...core.backends import group_rank, payload_bytes
from ...core.context import (default_communicator, default_context,
                             use_default)
from ...core.groups import DiompGroup
from ...core.rma import dispatch_window_names, ompx_fence, ompx_put
from .._build import (DTYPE_CODES, ROUTE_CODES, check_launch, library,
                      stream_handle)
from ..plan import (AllToAllPlan, expert_bwd_route, expert_bwd_scratch_elems,
                    expert_bwd_tiles, expert_bwd_work_words, expert_list_len,
                    expert_route)
from .kernel import expert_mlp_plain, rank_strided
from .ref import expert_mlp_bwd_plain, expert_mlp_ref

__all__ = [
    "FusedDispatchFn",
    "dispatch_buffers",
    "expert_slots",
    "fused_dispatch_blocks_plain",
    "fused_dispatch_bwd_kernel",
    "fused_dispatch_bwd_plain",
    "fused_moe_dispatch_interpret",
    "fused_moe_dispatch_kernel",
    "fused_moe_dispatch_plain",
    "kept_counts",
    "kernel_slots",
    "scatter_rows",
]

# phase codes of the kernel's schedule table (csrc/moe_dispatch.cu)
PHASES = {"put": 0, "fence": 1, "gemm": 2, "ret": 3, "fence_ret": 4}
MAX_RING = 64           # the kernel keeps its pending puts in a 64-bit mask


# ---------------------------------------------------------------------------
# routing -> buffer layout (both executions, and moe_block's capacity path)
# ---------------------------------------------------------------------------


def expert_slots(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Running index of each (token, choice) within its expert — a cumsum
    over a one-hot, as ``moe_block`` assigns slots.  ``e_flat (R, n)``."""
    onehot = F.one_hot(e_flat, E)
    return ((onehot.cumsum(-2) - 1) * onehot).sum(-1)


def scatter_rows(toks: torch.Tensor, k: int, keep: torch.Tensor,
                 addr: torch.Tensor, rows: int) -> torch.Tensor:
    """Per rank a ``(rows, d)`` buffer whose row ``addr[r, i]`` holds token
    ``i // k`` of ``toks (R, t, d)`` where ``keep`` and zeros elsewhere.
    Kept addresses are unique, so the copy has no order to depend on;
    dropped rows go to one discarded row past the end."""
    R, _, d = toks.shape
    flat = torch.zeros(R * rows + 1, d, dtype=toks.dtype, device=toks.device)
    base = torch.arange(R, device=toks.device)[:, None] * rows
    dest = torch.where(keep, base + addr, R * rows)
    flat.index_copy_(0, dest.reshape(-1),
                     toks.repeat_interleave(k, dim=1).reshape(-1, d))
    return flat[:R * rows].view(R, rows, d)


def kept_counts(e_flat: torch.Tensor, keep: torch.Tensor,
                E: int) -> torch.Tensor:
    """``(R, E)`` int32: the kept rows each expert receives from each rank
    (one bincount of the kept choices) — the live rows of its block."""
    counts = torch.zeros(e_flat.shape[0], E, dtype=torch.int32,
                         device=e_flat.device)
    return counts.scatter_add_(1, e_flat, keep.to(torch.int32))


def dispatch_buffers(toks, top_e, top_w, plan: AllToAllPlan):
    """Scatter routed rows into the padded per-destination wire blocks.

    Slot assignment is ``moe_block``'s running-index cumsum, checked
    against the plan's per-expert asymmetric capacity.  Returns, with the
    leading (rank) dims of ``toks``:

    * ``buf (..., ep, E_loc, cap_pad, d)`` — destination-rank-major wire
      blocks (rows past each expert's kept rows stay zero),
    * ``addr (..., t_loc·k)`` — the row of each (token, choice) in the
      ``(E·cap_pad, d)`` landing layout (the combine's unpermute),
    * ``gates (..., t_loc·k, 1)`` — combine weights, zero for dropped rows,
    * ``dropped (...)`` — f32 count of capacity-overflow drops,
    * ``counts (..., ep, E_loc)`` — int32 kept rows a block of each expert.
    """
    lead = toks.shape[:-2]
    t_loc, d = toks.shape[-2:]
    k = top_e.shape[-1]
    E, C = plan.E, plan.cap_pad
    R = math.prod(lead)
    e_flat = top_e.reshape(R, t_loc * k).long()
    slot = expert_slots(e_flat, E)
    caps = torch.tensor(plan.caps, dtype=torch.long, device=toks.device)
    keep = slot < caps[e_flat]
    addr = e_flat * C + slot.clamp(0, C - 1)
    buf = scatter_rows(toks.reshape(R, t_loc, d), k, keep, addr, E * C)
    gates = (keep[..., None] * top_w.reshape(R, -1)[..., None]).to(toks.dtype)
    dropped = (~keep).sum(-1).float()
    counts = kept_counts(e_flat, keep, E)
    return (buf.view(*lead, plan.ep, plan.E_loc, C, d),
            addr.view(*lead, t_loc * k), gates.view(*lead, t_loc * k, 1),
            dropped.view(lead), counts.view(*lead, plan.ep, plan.E_loc))


def _combine(full, addr, gates, t_loc: int, d: int):
    """Unpermute the landed expert outputs back to (token, choice) order
    and gate-combine: ``full (..., ep, E_loc, C, d)`` -> ``(..., t_loc,
    d)``."""
    lead = addr.shape[:-1]
    R = math.prod(lead)
    ret = full.reshape(R, -1, d)
    rows = torch.arange(R, device=full.device)[:, None]
    picked = ret[rows, addr.reshape(R, -1)] * gates.reshape(R, -1, 1)
    return picked.reshape(*lead, t_loc, -1, d).sum(dim=-2)


def _pick(x: torch.Tensor, idx: torch.Tensor, nd: int) -> torch.Tensor:
    """Per rank ``x[rank, idx[rank]]``: x ``(*mesh, n, ...)``, idx
    ``(*mesh,)`` (``lax.dynamic_slice`` by a traced rank index)."""
    R = idx.numel()
    flat = x.reshape(R, *x.shape[nd:])
    got = flat[torch.arange(R, device=x.device), idx.reshape(R)]
    return got.reshape(*x.shape[:nd], *x.shape[nd + 1:])


# ---------------------------------------------------------------------------
# the emulation: the same schedule over ompx_put
# ---------------------------------------------------------------------------


def fused_moe_dispatch_interpret(
    toks, top_e, top_w, wg, wu, wd, group: DiompGroup, *,
    plan: AllToAllPlan, mlp: Optional[Callable] = None,
):
    """Execute :meth:`AllToAllPlan.schedule` with ``ompx_put`` as the
    remote copy: every dispatch put starts before the GEMM it overlaps,
    every combine put after the GEMM that produced it.  ``mlp`` (default
    :func:`~.ref.expert_mlp_ref`) runs each landed block.  Returns
    ``(combined (..., t_loc, d), dropped (...))``.
    """
    mlp = mlp or expert_mlp_ref
    ctx = default_context()
    mesh = ctx.require_mesh()
    nd = mesh.ndim
    ep = plan.ep
    t_loc, d = toks.shape[-2:]
    me = group_rank(group, mesh, toks.device)

    buf, addr, gates, dropped, _ = dispatch_buffers(toks, top_e, top_w, plan)
    tracker = ctx.rma
    dwin, cwin = dispatch_window_names(group, ep)

    landed = {0: _pick(buf, me, nd)}
    outs, rets = {}, {}
    for phase, s in plan.schedule():
        if phase == "put":
            blk = _pick(buf, (me + s) % ep, nd)
            tracker.ensure(dwin[s - 1])
            tracker.on_put(dwin[s - 1], payload_bytes(blk, mesh.size))
            landed[s] = ompx_put(blk, group, shift=s)
        elif phase == "fence":
            landed[s] = ompx_fence(landed[s])
            tracker.on_fence(dwin[s - 1])
            tracker.on_read(dwin[s - 1])
        elif phase == "gemm":
            outs[s] = mlp(landed[s], wg, wu, wd).to(toks.dtype)
        elif phase == "ret":
            tracker.ensure(cwin[s - 1])
            tracker.on_put(cwin[s - 1], payload_bytes(outs[s], mesh.size))
            rets[s] = ompx_put(outs[s], group, shift=-s)
        elif phase == "fence_ret":
            if rets:
                order = sorted(rets)
                fenced = ompx_fence(*[rets[o] for o in order])
                if len(order) == 1:
                    fenced = (fenced,)
                rets = dict(zip(order, fenced))
                tracker.on_fence(*cwin)
                for w in cwin:
                    tracker.on_read(w)
        else:  # pragma: no cover - schedule() emits only the above
            raise ValueError(phase)

    # the returns in home-rank-major (global expert) order
    full = torch.zeros_like(buf)
    R = me.numel()
    rows = torch.arange(R, device=toks.device)
    flat = full.view(R, *full.shape[nd:])
    flat[rows, me.reshape(R)] = outs[0].reshape(R, *outs[0].shape[nd:])
    for s, blk in rets.items():
        flat[rows, ((me + s) % ep).reshape(R)] = blk.reshape(
            R, *blk.shape[nd:])
    return _combine(full, addr, gates, t_loc, d), dropped


def fused_moe_dispatch_plain(toks, top_e, top_w, wg, wu, wd,
                             group: DiompGroup, *, plan: AllToAllPlan):
    """The fused kernel's function in plain PyTorch: the emulation with the
    expert MLP's plain version."""
    return fused_moe_dispatch_interpret(toks, top_e, top_w, wg, wu, wd,
                                        group, plan=plan,
                                        mlp=expert_mlp_plain)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def kernel_slots(plan: AllToAllPlan) -> int:
    """Landing (and return) slots the kernel allocates: the reference's
    ``max(plan.slots, min(ep, 3))`` on the overlapped schedule; the
    serialized one lands every block before its first GEMM, so it needs
    one slot a remote block."""
    slots = max(plan.slots, min(plan.ep, 3))
    return slots if plan.overlap else max(slots, plan.ep - 1)


def _schedule_table(plan: AllToAllPlan, device) -> torch.Tensor:
    rows = [[PHASES[phase], s] for phase, s in plan.schedule()]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _record_traffic(blk, group: DiompGroup, plan: AllToAllPlan) -> None:
    """Log the schedule's puts as the emulation logs them: the OMPCCL call
    and byte logs and the RMATracker's windows (``blk`` is one padded wire
    block of every rank)."""
    ctx = default_context()
    comm = default_communicator(group)
    tracker = ctx.rma
    nbytes = payload_bytes(blk, ctx.require_mesh().size)
    dwin, cwin = dispatch_window_names(group, plan.ep)
    for phase, s in plan.schedule():
        if phase in ("put", "ret"):
            win = (dwin if phase == "put" else cwin)[s - 1]
            tracker.ensure(win)
            tracker.on_put(win, nbytes)
            comm.record("put", blk)
        elif phase == "fence":
            tracker.on_fence(dwin[s - 1])
            tracker.on_read(dwin[s - 1])
        elif phase == "fence_ret" and plan.ep > 1:
            tracker.on_fence(*cwin)
            for w in cwin:
                tracker.on_read(w)


def _kernel_layout(mesh, group, plan):
    """``(ring_last, G)``: the kernel layout moves the ring's rank dim last
    of the mesh dims and folds the others into G independent rings."""
    nd = mesh.ndim
    ring = group.rank_dims(mesh)[0]
    return (lambda t: t.movedim(ring, nd - 1)), mesh.size // plan.ep


def _check_dispatch(toks_dtype, device, wg, wu, wd, d, mesh, group, plan):
    nd = mesh.ndim
    ep, E_loc = plan.ep, plan.E_loc
    f = wg.shape[-1]
    if len(group.axes) != 1 or group.axis_size(mesh) != ep:
        raise ValueError(f"plan for a ring of {ep} on group {group.axes}")
    if ep > MAX_RING:
        raise ValueError(f"the dispatch kernel takes rings of up to "
                         f"{MAX_RING} ranks, got {ep}")
    if any(w.dtype != toks_dtype or w.device != device
           for w in (wg, wu, wd)) or toks_dtype not in DTYPE_CODES:
        raise TypeError("fused_moe_dispatch: tokens and weights must share "
                        "one device and a f32/f16/bf16 dtype")
    if tuple(wg.shape[nd:]) != (E_loc, d, f) or wu.shape != wg.shape \
            or tuple(wd.shape[nd:]) != (E_loc, f, d):
        raise ValueError(f"expert weights {tuple(wg.shape)}, "
                         f"{tuple(wd.shape)} for a plan of {E_loc} local "
                         f"experts, d = {d}")


def fused_dispatch_blocks_plain(buf, wg, wu, wd, counts, group: DiompGroup):
    """The kernel's block-level function in plain PyTorch: ``buf (*mesh,
    ep, E_loc, C, d)`` -> the landed results ``full`` of the same layout,
    block j of rank r being rank j's experts on r's block j (its live rows
    ``counts (*mesh, ep, E_loc)``)."""
    mesh = default_context().require_mesh()
    ring, nd = group.rank_dims(mesh)[0], mesh.ndim
    # at home rank j the sources r are a (sources) dim sharing j's weights
    y = expert_mlp_plain(buf.transpose(ring, nd), wg, wu, wd,
                         counts.transpose(ring, nd))
    return y.transpose(ring, nd)


def fused_dispatch_bwd_plain(buf, wg, wu, wd, counts, dfull,
                             group: DiompGroup):
    """The gradient of :func:`fused_dispatch_blocks_plain` for the cotangent
    ``dfull``, as the backward kernel computes it: ``(dbuf, dwg, dwu,
    dwd)``, each rank's dW summed over every source's live rows."""
    mesh = default_context().require_mesh()
    ring, nd = group.rank_dims(mesh)[0], mesh.ndim
    dx, dwg, dwu, dwd = expert_mlp_bwd_plain(
        buf.transpose(ring, nd), wg, wu, wd, dfull.transpose(ring, nd),
        counts.transpose(ring, nd))
    return dx.transpose(ring, nd), dwg, dwu, dwd


def _dispatch_launch(buf, wg, wu, wd, counts, group, plan):
    """One launch of ``csrc/moe_dispatch.cu`` on the wire blocks ``buf``;
    returns ``full`` in buf's layout."""
    mesh = default_context().require_mesh()
    nd = mesh.ndim
    ep, E_loc, C = plan.ep, plan.E_loc, plan.cap_pad
    d, f = buf.shape[-1], wg.shape[-1]
    ring_last, G = _kernel_layout(mesh, group, plan)
    kb = ring_last(buf).contiguous()
    (wg, sg), (wu, su), (wd, sd) = (rank_strided(ring_last(w))
                                    for w in (wg, wu, wd))
    kc = ring_last(counts).contiguous()
    out = torch.empty_like(kb)
    slots = kernel_slots(plan)
    stage = torch.empty(G, ep, slots, E_loc, C, d, dtype=buf.dtype,
                        device=buf.device)
    ret_stage = torch.empty_like(stage)
    h = torch.empty(G, ep, E_loc, C, f, dtype=buf.dtype, device=buf.device)
    sched = _schedule_table(plan, buf.device)
    isz = buf.element_size()
    # TMA reads the local blocks, the landing slots, the weights (their rank
    # strides in bytes) and h
    route = expert_route(buf.dtype, d, f, kb.data_ptr(), stage.data_ptr(),
                         wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                         h.data_ptr(), sg * isz, su * isz, sd * isz)
    if route == "wgmma":    # a work list a GEMM phase, built on the card
        work = torch.empty(ep * expert_list_len(G * ep * E_loc, C),
                           dtype=torch.int32, device=buf.device)
    else:                   # two tile counters a GEMM phase
        work = torch.zeros(2 * ep, dtype=torch.int64, device=buf.device)
    status = library("moe_dispatch").repro_moe_dispatch(
        kb.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        kc.data_ptr(), out.data_ptr(), stage.data_ptr(), ret_stage.data_ptr(),
        h.data_ptr(), sched.data_ptr(), work.data_ptr(), sg, su, sd,
        sched.shape[0], G, ep,
        slots, E_loc, C, d, f, DTYPE_CODES[buf.dtype], ROUTE_CODES[route],
        stream_handle(buf.device))
    fused_moe_dispatch_kernel.launches += 1
    fused_moe_dispatch_kernel.route_launches[route] += 1
    check_launch(status, "fused_moe_dispatch")
    return out.movedim(nd - 1, group.rank_dims(mesh)[0])


def fused_dispatch_bwd_kernel(buf, wg, wu, wd, counts, dfull,
                              group: DiompGroup, *, plan: AllToAllPlan):
    """The gradient of the kernel's block-level function for the cotangent
    ``dfull``: ``(dbuf, dwg, dwu, dwd)``, on the card one launch of
    ``csrc/moe_dispatch_bwd.cu`` (counted in ``.launches``, and by route in
    ``.route_launches``: :func:`..plan.expert_bwd_route`'s rule; the bytes
    of its scratch and staging in ``.transient_bytes``), on CPU tensors
    :func:`fused_dispatch_bwd_plain`.  The kernel follows the plan's
    schedule with one landing slot a remote block (``ep - 1``), so every
    block stays landed until the dW pass has read it; on the tensor cores
    a block lands as its live rows, packed by weight set, and the packed
    layout is sized by every rank's ``t_loc * k`` choices, the most live
    rows the dropless plan sends."""
    if not buf.is_cuda:
        return fused_dispatch_bwd_plain(buf, wg, wu, wd, counts, dfull, group)
    mesh = default_context().require_mesh()
    nd = mesh.ndim
    ep, E_loc, C = plan.ep, plan.E_loc, plan.cap_pad
    d, f = buf.shape[-1], wg.shape[-1]
    _check_dispatch(buf.dtype, buf.device, wg, wu, wd, d, mesh, group, plan)
    if dfull.shape != buf.shape:
        raise ValueError(f"fused_dispatch_bwd: cotangent {tuple(dfull.shape)}"
                         f" for blocks {tuple(buf.shape)}")
    ring_last, G = _kernel_layout(mesh, group, plan)
    kb = ring_last(buf).contiguous()
    kd = ring_last(dfull.to(buf.dtype)).contiguous()
    (wg_k, sg), (wu_k, su), (wd_k, sd) = (rank_strided(ring_last(w))
                                          for w in (wg, wu, wd))
    kc = ring_last(counts).contiguous()
    dbuf = torch.empty_like(kb)
    # each dW in the ring-last layout, contiguous: (G, ep, E_loc, ...)
    dw = [torch.empty(*kb.shape[:nd], E_loc, *s, dtype=buf.dtype,
                      device=buf.device) for s in ((d, f), (d, f), (f, d))]
    slots = max(ep - 1, 1)
    sched = _schedule_table(plan, buf.device)
    isz = buf.element_size()
    # the tensor cores read the weights by TMA (their rank strides in
    # bytes) and the blocks and cotangents 16 bytes a lane
    route = expert_bwd_route(buf.dtype, d, f, kb.data_ptr(), kd.data_ptr(),
                             wg_k.data_ptr(), wu_k.data_ptr(),
                             wd_k.data_ptr(), sg * isz, su * isz, sd * isz)
    sets = G * ep * E_loc
    if route == "wgmma":
        # every weight set's live rows over the ring's offsets, packed in
        # 64-row tiles (x and the cotangent, then dg, du and h)
        tiles = expert_bwd_tiles(sets, ep, C,
                                 rows=G * ep * plan.t_loc * plan.k)
        scratch = torch.empty(expert_bwd_scratch_elems(tiles, d, f),
                              dtype=buf.dtype, device=buf.device)
        work = torch.empty(expert_bwd_work_words(sets, ep, tiles),
                           dtype=torch.int32, device=buf.device)
        stages = ()
    else:
        tiles = 0
        stages = tuple(torch.empty(G, ep, slots, E_loc, C, d, dtype=buf.dtype,
                                   device=buf.device) for _ in range(3))
        # dg, du and h of every (rank, offset) block, kept until the dW pass
        scratch = torch.empty(3, G * ep * ep * E_loc * C * f,
                              dtype=buf.dtype, device=buf.device)
        work = torch.empty(0, dtype=torch.int32, device=buf.device)
    fused_dispatch_bwd_kernel.transient_bytes = sum(
        t.numel() * t.element_size() for t in (scratch, work, *stages))
    xstage, dstage, ret_stage = (s.data_ptr() for s in stages) if stages \
        else (None, None, None)
    status = library("moe_dispatch_bwd").repro_moe_dispatch_bwd(
        kb.data_ptr(), kd.data_ptr(), wg_k.data_ptr(), wu_k.data_ptr(),
        wd_k.data_ptr(), kc.data_ptr(), dbuf.data_ptr(),
        *(w.data_ptr() for w in dw), xstage, dstage, ret_stage,
        scratch.data_ptr(), sched.data_ptr(), work.data_ptr(), sg, su, sd,
        sched.shape[0], G, ep, slots, E_loc, C, d, f, tiles,
        DTYPE_CODES[buf.dtype], ROUTE_CODES[route], stream_handle(buf.device))
    fused_dispatch_bwd_kernel.launches += 1
    fused_dispatch_bwd_kernel.route_launches[route] += 1
    check_launch(status, "fused_moe_dispatch_bwd")
    del stages, scratch, work
    ring = group.rank_dims(mesh)[0]
    return tuple(t.movedim(nd - 1, ring) for t in (dbuf, *dw))


fused_dispatch_bwd_kernel.launches = 0
fused_dispatch_bwd_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
fused_dispatch_bwd_kernel.transient_bytes = 0


class FusedDispatchFn(torch.autograd.Function):
    """The fused dispatch's block-level function with a gradient: ``buf``
    and the local experts' weights -> the landed results ``full``, the
    forward kernel (row 8) and the backward kernel (row 13), on the card
    only.  Saves buf, the weights and the counts."""

    @staticmethod
    def forward(fctx, buf, wg, wu, wd, counts, group, plan):
        if not buf.is_cuda:
            raise ValueError("FusedDispatchFn runs on the card; on the CPU "
                             "the emulation is differentiated")
        fctx.save_for_backward(buf, wg, wu, wd, counts)
        # the backward runs in the autograd engine's thread, where the
        # caller's use_default scope is not seen
        fctx.group, fctx.plan, fctx.dctx = group, plan, default_context()
        return _dispatch_launch(buf, wg, wu, wd, counts, group, plan)

    @staticmethod
    def backward(fctx, dfull):
        buf, wg, wu, wd, counts = fctx.saved_tensors
        with use_default(fctx.dctx):
            dbuf, dwg, dwu, dwd = fused_dispatch_bwd_kernel(
                buf, wg, wu, wd, counts, dfull, fctx.group, plan=fctx.plan)
        need = fctx.needs_input_grad
        return (dbuf if need[0] else None, dwg if need[1] else None,
                dwu if need[2] else None, dwd if need[3] else None,
                None, None, None)


def fused_moe_dispatch_kernel(toks, top_e, top_w, wg, wu, wd,
                              group: DiompGroup, *, plan: AllToAllPlan):
    """Dispatch, expert MLP and return of every rank in one launch of
    ``csrc/moe_dispatch.cu`` (counted in ``.launches``, and by route in
    ``.route_launches``: :func:`..plan.expert_route`'s, the expert-MLP
    kernel's rule), the routing scatter and the combine around it in torch,
    with a gradient through :class:`FusedDispatchFn`; on CPU tensors, the
    plain version (the emulation, differentiable as it stands).  Returns
    ``(combined (..., t_loc, d), dropped (...))``."""
    if not toks.is_cuda:
        return fused_moe_dispatch_plain(toks, top_e, top_w, wg, wu, wd,
                                        group, plan=plan)
    mesh = default_context().require_mesh()
    nd = mesh.ndim
    t_loc, d = toks.shape[-2:]
    _check_dispatch(toks.dtype, toks.device, wg, wu, wd, d, mesh, group, plan)
    buf, addr, gates, dropped, counts = dispatch_buffers(toks, top_e, top_w,
                                                         plan)
    _record_traffic(buf.select(nd, 0), group, plan)
    full = FusedDispatchFn.apply(buf, wg, wu, wd, counts, group, plan)
    return _combine(full, addr, gates, t_loc, d), dropped


fused_moe_dispatch_kernel.launches = 0
fused_moe_dispatch_kernel.route_launches = dict.fromkeys(ROUTE_CODES, 0)
