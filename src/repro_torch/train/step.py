"""The train step: gradient accumulation, the explicit OMPCCL gradient
reduction and the optimizer, on stacked ranks (the reference's
``repro/train/step.py``).

The reference runs the step inside one ``shard_map``; the port runs it
once on stacked tensors whose leading dims are the mesh axes, with
``torch.autograd`` in place of ``jax.value_and_grad``.

* **Per-rank gradients.**  Every rank's replica of a parameter is its own
  slice of the stacked tensor, so autograd yields each rank's own gradient
  and no cross-batch reduction happens inside it.  The loss comes out
  replicated over the non-DP (model) axes; the backward is seeded with
  each DP rank's own loss and the mean over its model replicas, and the
  gradient of a parameter replicated over the model axis is then summed
  over its replicas: what the reference's AD does inside (the transpose of
  its implicit ``pvary``), unlogged as there.  ZeRO-3 gathers
  (``gather_fsdp``) reduce-scatter over "data" in the backward the same
  way, unlogged, as the reference's AD does.
* ``ctx.explicit_dp=True`` (DiOMP mode): the DP mean then runs explicitly
  through OMPCCL, in the planned flat buckets of
  :mod:`repro_torch.distributed.buckets` (``ctx.bucket_bytes > 0``) or
  one collective a parameter, with the flat, hierarchical or int8
  backends.  ``explicit_dp=False`` is the implicit baseline: replicas are
  summed as AD would, off the OMPCCL logs.
* With ``microbatch > 1``, ``overlap_grad_reduce`` and no codec, each
  microbatch's buckets reduce-scatter inside the accumulation loop and one
  invariant all-gather a bucket follows it (the same mean, split RS + AG).
* Under ``layout="dp_only"`` the model axis is a DP axis: the batch
  splits over ``dp_all`` (pod, data, model), no axis is left to fold
  replicas over, and the buckets reduce over the DP axes each
  parameter's placement leaves unused ("model" among them); the int8
  codec takes the buckets over the whole DP group, as in the reference.
* Logs follow the reference's trace-time rule: the reference traces its
  jitted step once, and the microbatch loop's body once in it, so a built
  step logs on its first call (for each input signature), the first
  microbatch against the active context and the rest against its scratch
  context; each layer's recompute under remat logs against the scratch
  context too.

``step(params, opt_state, batch, step_idx) -> (params', opt_state',
metrics)``; metrics are ``(*mesh,)`` tensors, replicated: ``loss`` and
``grad_norm``, and for MoE configs ``moe_dropped`` (the capacity-overflow
drops summed over layers, microbatches and the world) and
``moe_drop_rate`` (over the routed (token, choice) pairs).  Each
microbatch's loss runs inside a ``dispatch_stats`` frame that closes
before its backward, so a checkpointed layer's recompute (which runs
``moe_block`` again, with the forward's stats lent to it) records into no
frame and the drops count once, as the reference's, whose frame opens in
the traced loss alone.  With ``donate=True`` (the reference's default) the step
updates ``params`` and ``opt_state`` in place (the reference donates their
buffers), so a caller must not reuse them; ``donate=False`` leaves them
untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.context import default_context, recorded_once
from ..core.groups import group_for_axes
from ..distributed import buckets as bk
from ..distributed.buckets import unreduced_dp_axes as _unreduced_dp_axes
from ..distributed.compression import compressed_allreduce
from ..launch.mesh import RankMesh
from ..models import api as model_api
from ..models import schema as sch
from ..models.config import ModelConfig, ParallelCtx
from ..serve.step import _signature
from .optim import Optimizer, bucketed_sq_norm

__all__ = ["build_train_step", "opt_state_specs", "reduce_gradients",
           "sharded_global_norm", "fold_replicas", "per_rank_grads"]

F32 = torch.float32


def _spec_drop_dim(spec: tuple, drop: int) -> tuple:
    parts = list(spec)
    del parts[drop]
    return tuple(parts)


def opt_state_specs(cfg: ModelConfig, mesh: RankMesh, optimizer_name: str,
                    rules=None):
    """Specs of the optimizer state (they mirror the parameters')."""
    pspecs = sch.partition_specs(cfg, mesh, rules)
    schema = sch.build_schema(cfg)
    if optimizer_name == "adamw":
        return {"m": dict(pspecs), "v": dict(pspecs)}
    out = {}
    for name, spec in pspecs.items():
        shape = schema[name].shape
        rank = len(shape)
        if rank >= 2 and shape[-1] > 1 and shape[-2] > 1:
            out[name] = {"vr": _spec_drop_dim(spec, rank - 1),
                         "vc": _spec_drop_dim(spec, rank - 2)}
        else:
            out[name] = {"v": spec}
    return out


def _local_sq(g: torch.Tensor, nd: int) -> torch.Tensor:
    return g.float().pow(2).sum(tuple(range(nd, g.dim())))


def sharded_global_norm(grads, cfg: ModelConfig, ctx: ParallelCtx,
                        mesh: RankMesh, pspecs: Optional[dict] = None, *,
                        plan=None, bufs=None) -> torch.Tensor:
    """Global L2 norm of stacked per-rank gradients, ``(*mesh,)``.

    Each parameter's per-rank sum of squares is weighted by
    1/duplication (replicated copies count once) and summed over the world
    group through OMPCCL.  With the reduced flat buckets at hand
    (``plan`` + ``bufs``), one sum a bucket replaces the per-parameter
    loop; only the plan's unbucketed parameters walk it."""
    nd = mesh.ndim
    dev = next(iter(grads.values())).device
    total = torch.zeros(mesh.sizes, dtype=F32, device=dev)
    if plan is not None and bufs is not None:
        if plan.buckets:
            total = total + bucketed_sq_norm(bufs, plan, nd)
        for name in plan.local:
            total = total + _local_sq(grads[name], nd) / plan.dups[name]
    else:
        if pspecs is None:
            from ..distributed.sharding import rules_for_ctx
            pspecs = sch.partition_specs(cfg, mesh, rules_for_ctx(ctx))
        for name, g in grads.items():
            dup = bk.duplication_factor(pspecs[name], mesh.shape)
            total = total + _local_sq(g, nd) / dup
    total = default_context().communicator(ctx.world).allreduce(total)
    return torch.sqrt(total)


def reduce_gradients(grads: Dict[str, torch.Tensor], cfg: ModelConfig,
                     ctx: ParallelCtx, errors: Optional[dict] = None,
                     pspecs: Optional[dict] = None,
                     mesh: Optional[RankMesh] = None, plan=None):
    """Explicit DP mean-reduction through OMPCCL of per-rank stacked
    gradients; returns ``(reduced_grads, new_errors)``.

    A parameter needs reduction only over the DP axes its own sharding
    does not use (a ZeRO-3 shard had its sum over "data" folded in by the
    backward).  With a bucket plan (passed in, or derived when ``mesh`` is
    given and ``ctx.bucket_bytes > 0``) whole buckets reduce through one
    handle each (errors keyed by bucket); otherwise one collective a
    parameter (errors keyed by name)."""
    from ..distributed.sharding import rules_for_ctx

    if plan is None and mesh is not None and ctx.bucket_bytes:
        plan = bk.plan_for_config(cfg, mesh, ctx)
    if plan is not None:
        out, _bufs, new_errors = bk.reduce_bucketed(grads, plan, ctx,
                                                    errors=errors)
        return out, new_errors

    dctx = default_context()
    mesh = dctx.require_mesh() if mesh is None else mesh
    if pspecs is None:
        pspecs = sch.partition_specs(cfg, mesh, rules_for_ctx(ctx))
    new_errors = {}
    out = {}
    dp_axes = ctx.dp_group.axes
    for name, g in grads.items():
        need = _unreduced_dp_axes(pspecs[name], dp_axes)
        g = g.float() / ctx.dp
        if not need:
            out[name] = g
            continue
        group = group_for_axes(need)
        if ctx.grad_codec == "int8" and set(need) == set(dp_axes):
            err = errors.get(name) if errors else None
            g, e = compressed_allreduce(g * ctx.dp, group, mesh, error=err)
            new_errors[name] = e
        else:
            backend = bk.backend_for_axes(need, ctx)
            g = dctx.communicator(group, backend).allreduce(g)
        out[name] = g
    return out, new_errors


def fold_replicas(grads: Dict[str, torch.Tensor], pspecs: dict,
                  mesh: RankMesh, axes) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the mesh ``axes`` its parameter is
    replicated over (not named in its spec), every replica receiving the
    sum: the reduction the reference's AD runs inside the backward (the
    transpose of an implicit ``pvary``), on no OMPCCL log."""
    out = {}
    for name, g in grads.items():
        used = set(bk.spec_axes(pspecs[name]))
        dims = tuple(mesh.dim(a) for a in axes if a not in used)
        out[name] = g.sum(dims, keepdim=True).expand_as(g) if dims else g
    return out


def per_rank_grads(params: Dict[str, torch.Tensor], batch, cfg: ModelConfig,
                   ctx: ParallelCtx, mesh: RankMesh, *, pspecs=None,
                   loss_fn=None):
    """Each rank's loss ``(*mesh,)`` and its own gradient of it, stacked.

    The backward is seeded with the sum of the ranks' losses over the DP
    axes and their mean over the other (model) axes, over which the loss
    is replicated; then each gradient is summed over the non-DP axes its
    parameter is replicated over (in the implicit baseline,
    ``ctx.explicit_dp=False``, over its DP replicas too): what the
    reference's AD gives under ``shard_map`` with the parameters made
    varying over the DP axes, before any explicit reduction."""
    if pspecs is None:
        from ..distributed.sharding import rules_for_ctx
        pspecs = sch.partition_specs(cfg, mesh, rules_for_ctx(ctx))
    loss_fn = loss_fn or model_api.loss_fn(cfg)
    dp_axes = tuple(ctx.dp_group.axes)
    rep_axes = tuple(a for a in mesh.axis_names if a not in dp_axes)
    n_rep = 1
    for a in rep_axes:
        n_rep *= mesh.shape[a]
    names = sorted(params)
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    loss = loss_fn(leaves, batch, cfg, ctx)                    # (*mesh,)
    got = torch.autograd.grad(loss.sum() / n_rep,
                              [leaves[n] for n in names], allow_unused=True)
    g = {n: torch.zeros_like(leaves[n]) if x is None else x
         for n, x in zip(names, got)}
    fold = rep_axes if ctx.explicit_dp else tuple(mesh.axis_names)
    return loss.detach(), fold_replicas(g, pspecs, mesh, fold)


def _microbatches(batch: Dict[str, torch.Tensor], nd: int, want: int):
    """The batch cut into ``k`` microbatches along the per-rank batch dim,
    ``k`` the largest divisor of the local batch not above ``want``."""
    b_local = next(iter(batch.values())).shape[nd]
    k = max(min(want, b_local), 1)
    while b_local % k:
        k -= 1
    size = b_local // k
    return [{n: t.narrow(nd, i * size, size) for n, t in batch.items()}
            for i in range(k)]


def build_train_step(cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx,
                     optimizer: Optimizer, *, optimizer_name: str = "adamw",
                     clip_norm: float = 1.0, donate: bool = True):
    """Returns ``step(params, opt_state, batch, step_idx) -> (params',
    opt_state', metrics)`` for stacked tensors on the active context's mesh
    (``batch`` laid out by :func:`repro_torch.models.api.batch_structs`'
    specs).  The ring, dispatch and sequence-parallel knobs and the bucket
    plan resolve here, once, through the active context's planner.  The
    reference's ``global_batch`` (its batch sharding) has no counterpart:
    the port's batch arrives already split."""
    from ..distributed.sharding import rules_for_ctx
    from ..kernels.plan import (default_planner, resolve_dispatch_impl,
                                resolve_ring_impl, resolve_seq_parallel)

    ctx = dataclasses.replace(
        ctx, ring_impl=resolve_ring_impl(ctx.ring_impl),
        dispatch_impl=resolve_dispatch_impl(ctx.dispatch_impl),
        seq_parallel=resolve_seq_parallel(ctx.seq_parallel))
    rules = rules_for_ctx(ctx)
    loss_fn = model_api.loss_fn(cfg)
    pspecs = sch.partition_specs(cfg, mesh, rules)
    dp_axes = tuple(ctx.dp_group.axes)
    nd = mesh.ndim
    # the reduction schedule resolves once, here, from static shapes
    plan = (default_planner().plan_grad_buckets(cfg, mesh, ctx)
            if ctx.explicit_dp and dp_axes and ctx.bucket_bytes else None)

    def grads_of(params, mb, stats):
        # the frame covers the forward only (the reference opens it inside
        # its traced loss): the backward's recomputes record nowhere
        def framed(p, b, c, x):
            with default_context().dispatch_stats.collect() as ds:
                out = loss_fn(p, b, c, x)
            for key, val in ds.items():
                stats[key] = stats[key] + val if key in stats else val
            return out
        return per_rank_grads(params, mb, cfg, ctx, mesh, pspecs=pspecs,
                              loss_fn=framed)

    def run(params, opt_state, batch, step_idx):
        dctx = default_context()
        if dctx.require_mesh() != mesh:
            raise ValueError(f"the active context's mesh {dctx.mesh} is not "
                             f"the step's {mesh}")
        names = sorted(params)
        mbs = _microbatches(batch, nd, ctx.microbatch)
        k = len(mbs)
        overlap = (plan is not None and bool(plan.buckets) and k > 1
                   and ctx.overlap_grad_reduce and ctx.grad_codec == "none")
        bufs = None
        reduced = False
        loss = None
        stats = {}          # moe_dropped / moe_routed over the microbatches
        if overlap:
            acc = {n: None for n in plan.local}
            shards = {}
            for i, mb in enumerate(mbs):
                with recorded_once(i == 0) as rctx:
                    l, g = grads_of(params, mb, stats)
                    for n in plan.local:
                        # a replicated gradient is an expanded view: the
                        # accumulator owns a dense copy
                        acc[n] = g[n].float().contiguous() if acc[n] is None \
                            else acc[n].add_(g[n])
                    # this microbatch's buckets reduce-scatter now; the
                    # carry holds only each rank's 1/|group| shard
                    mb_bufs = bk.pack_buckets(g, plan, nd)
                    del g
                    for b in plan.buckets:
                        piece = rctx.communicator(
                            b.group, bk.backend_for_bucket(b, ctx)
                        ).reducescatter(mb_bufs.pop(b.key), axis=0)
                        shards[b.key] = piece if i == 0 \
                            else shards[b.key] + piece
                loss = l if loss is None else loss + l
            loss = loss / k
            # the trailing exchange: one invariant all-gather a bucket
            bufs = {b.key: dctx.communicator(
                        b.group, bk.backend_for_bucket(b, ctx)).allgather(
                            shards.pop(b.key) / (k * ctx.dp), axis=0,
                            tiled=True, invariant=True)
                    for b in plan.buckets}
            grads = {n: acc.pop(n).div_(k * ctx.dp) for n in plan.local}
            grads.update(bk.unpack_buckets(bufs, plan))
            reduced = True
        else:
            grads = None
            for i, mb in enumerate(mbs):
                with recorded_once(i == 0):
                    l, g = grads_of(params, mb, stats)
                loss = l if loss is None else loss + l
                if k == 1:
                    grads = g
                elif grads is None:
                    grads = {n: x.float().contiguous() for n, x in g.items()}
                else:
                    for n in names:
                        grads[n].add_(g[n])
                del g
            if k > 1:
                loss = loss / k
                grads = {n: x.div_(k) for n, x in grads.items()}

        if ctx.explicit_dp and dp_axes:
            if not reduced:
                if plan is not None:
                    grads, bufs, _ = bk.reduce_bucketed(grads, plan, ctx)
                else:
                    grads, _ = reduce_gradients(grads, cfg, ctx,
                                                pspecs=pspecs, mesh=mesh)
        else:
            grads = {n: g.float() / ctx.dp for n, g in grads.items()}

        gnorm = sharded_global_norm(
            grads, cfg, ctx, mesh, pspecs=pspecs,
            plan=plan if bufs is not None else None, bufs=bufs)
        del bufs
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for n in names:
            g = grads[n]
            grads[n] = g * scale.reshape(*scale.shape,
                                         *([1] * (g.dim() - nd)))
        updates, opt_state = optimizer.update(grads, opt_state, params,
                                              step_idx, inplace=donate)
        del grads
        if donate:
            for n in names:
                p = params[n]
                p.copy_((p.float() + updates.pop(n).float()).to(p.dtype))
        else:
            params = {n: (params[n].float() + updates.pop(n).float()
                          ).to(params[n].dtype) for n in names}
        world = dctx.communicator(ctx.world)
        metrics = {"loss": world.allreduce(loss, op="mean"),
                   "grad_norm": gnorm}
        if cfg.moe:
            # per-rank sums over layers x microbatches; the world sum is the
            # step's capacity-overflow drops (zero under fused / host)
            zero = torch.zeros(mesh.sizes, dtype=F32, device=loss.device)
            dropped = world.allreduce(stats.get("moe_dropped", zero))
            routed = world.allreduce(stats.get("moe_routed", zero))
            metrics["moe_dropped"] = dropped
            metrics["moe_drop_rate"] = dropped / torch.clamp(routed, min=1.0)
        return params, opt_state, metrics

    seen = set()

    def step(params, opt_state, batch, step_idx):
        # the reference traces its jitted step once: a built step logs on
        # its first call for each input signature, later calls silently
        sig = _signature((params, opt_state, batch))
        first = sig not in seen
        seen.add(sig)
        with recorded_once(first):
            return run(params, opt_state, batch, step_idx)

    return step
