"""The port's training slice held against the JAX package, piece by piece.

The reference's ``build_train_step`` fails on this box's jax 0.9 (its
``shard_map`` out_specs cannot be inferred), so each piece of the step is
held against the reference's own piece:

* the loss and every gradient leaf: reduced stablelm-3b (MHA), glm4-9b
  (GQA 8:1, replicated KV weights) and paligemma-3b (prefix-LM, token
  parallel) on the 8-rank smoke mesh, against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` in a test-built ``shard_map`` (parameters made
  varying over the DP axes, then each gradient divided by dp and summed
  over its unreduced DP axes: the reference's ``reduce_gradients``
  contract), on the same numpy weights and batch.  Tolerances: f32 loss
  1e-5 relative and gradients 1e-4 of each leaf's largest value (f32 sums
  in another order); bf16 loss 1e-3 and gradients 2e-2 (the model stack's
  bf16 bound: every product rounded to bf16 at other places);
* the bucket plan, record for record, against ``plan_for_config``;
* the reduction's call and byte logs against the reference's
  ``reduce_gradients`` traced in a ``shard_map``;
* the int8 codec's codes and scales (exactly), the compressed all-reduce
  with its error feedback over two steps, the top-k reduce, and the int8
  weight gather with its gradient, against the reference's;
* AdamW and Adafactor updates within 1e-6, and the cosine schedule;
* the microbatch loop with and without the overlapped bucket reduction;
* ``SyntheticLM`` batches, equal to the reference's;
* the launcher on the CPU, its loss falling.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.compat import shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import buckets as j_bk
from repro.distributed import compression as j_comp
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup, group_for_axes
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import buckets as bk
from repro_torch.distributed import compression as comp
from repro_torch.interop import (params_from_reference, stack_shards,
                                 unstack_shards)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import api, schema
from repro_torch.models.config import ParallelCtx
from repro_torch.models.layers import Q8Gather
from repro_torch.train import optim
from repro_torch.train.optim import Optimizer
from repro_torch.train.step import (build_train_step, per_rank_grads,
                                    reduce_gradients)

ARCHS = ("stablelm-3b", "glm4-9b", "paligemma-3b")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-3, 2e-2)}
B, S = 8, 16
MESH = make_smoke_mesh(8)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    structs, _ = api.batch_structs(cfg, MESH, B, S)
    out = {}
    for k, s in structs.items():
        if s.dtype == torch.int32:
            out[k] = rng.randint(0, cfg.vocab_size, s.shape).astype(np.int32)
        else:
            out[k] = (rng.randn(*s.shape) * 0.1).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch, dt, mesh8):
    """The reference's mean loss and DP-reduced gradients (global view)."""
    jcfg = j_configs.get_reduced(arch)
    jdt = DTYPES[dt][0]
    jp = {k: v.astype(jdt) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    jctx = JCtx.from_mesh(mesh8, remat=True)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    dp = jctx.dp_group.axes
    loss_fn = j_api.loss_fn(jcfg)

    def body(params, batch):
        p = j_ompccl.ensure_varying(params, dp)
        loss, g = jax.value_and_grad(
            lambda p: loss_fn(p, batch, jcfg, jctx))(p)
        out = {}
        for n, v in g.items():
            need = j_bk.unreduced_dp_axes(pspecs[n], dp)
            v = v.astype(jnp.float32) / jctx.dp
            out[n] = lax.psum(v, need) if need else v
        return lax.pmean(loss, dp), out

    batch = _batch(configs.get_reduced(arch))
    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=(P(), pspecs))
    with j_use_default(JContext(mesh=mesh8)):
        loss, grads = jax.jit(f)(jp, {k: jnp.asarray(v).astype(
            jdt if v.dtype == np.float32 else v.dtype)
            for k, v in batch.items()})
    return jp, float(loss), {n: _np(g) for n, g in grads.items()}


def _port_params(arch, dt, jp):
    cfg = configs.get_reduced(arch)
    return cfg, params_from_reference(cfg, MESH, {k: _np(v)
                                                  for k, v in jp.items()},
                                      dtype=DTYPES[dt][1])


def _port_batch(cfg, dt, ctx):
    _, bspecs = api.batch_structs(cfg, MESH, B, S, dp_axes=ctx.dp_axes)
    return {k: stack_shards(v, MESH, bspecs[k],
                            dtype=DTYPES[dt][1] if v.dtype == np.float32
                            else None)
            for k, v in _batch(cfg).items()}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dt, mesh8):
    jp, jloss, jgrads = _reference(arch, dt, mesh8)
    cfg, tp = _port_params(arch, dt, jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    _, ltol, gtol = DTYPES[dt][1:]
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        loss, grads = per_rank_grads(tp, _port_batch(cfg, dt, ctx), cfg, ctx,
                                     MESH)
        red, _ = reduce_gradients(grads, cfg, ctx, mesh=MESH)
    assert abs(float(loss.mean()) - jloss) <= ltol * abs(jloss)
    specs = schema.partition_specs(cfg, MESH)
    assert sorted(red) == sorted(jgrads)
    for n, want in jgrads.items():
        got = unstack_shards(red[n], MESH, specs[n])
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= gtol * scale, n


def _plan_records(plan):
    return (tuple((b.key, b.axes, b.dtype, b.dup, b.index, b.size,
                   b.padded_size, tuple(dataclasses.astuple(s)
                                        for s in b.slices))
                  for b in plan.buckets),
            tuple(plan.local), dict(plan.shapes), dict(plan.dups),
            plan.bucket_bytes)


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"bucket_bytes": 4096,
                                    "grad_codec": "int8"}],
                         ids=["default", "4KiB", "4KiB-int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_plan_equals_reference(arch, knobs, mesh8):
    cfg = configs.get_reduced(arch)
    plan = bk.plan_for_config(cfg, MESH, ParallelCtx.from_mesh(MESH, **knobs))
    jplan = j_bk.plan_for_config(j_configs.get_reduced(arch), mesh8,
                                 JCtx.from_mesh(mesh8, **knobs))
    assert _plan_records(plan) == _plan_records(jplan)
    assert plan.bucket_count() == jplan.bucket_count()
    assert plan.total_bytes() == jplan.total_bytes()


def test_built_step_plans_through_the_planner(monkeypatch, mesh8):
    """``build_train_step`` resolves its bucket plan once, at build time,
    through the active context's planner; the planner's plan is the
    reference planner's, record for record."""
    from repro.kernels.plan import default_planner as j_default_planner
    from repro_torch.kernels import plan as plan_mod

    cfg = configs.get_reduced("glm4-9b")
    ctx = ParallelCtx.from_mesh(MESH, bucket_bytes=4096)
    seen = []
    real = plan_mod.OverlapPlanner.plan_grad_buckets

    def spy(self, *args):
        seen.append(real(self, *args))
        return seen[-1]

    monkeypatch.setattr(plan_mod.OverlapPlanner, "plan_grad_buckets", spy)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        build_train_step(cfg, MESH, ctx, _sgd(1.0))
        assert len(seen) == 1
    with j_use_default(JContext(mesh=mesh8)):
        jplan = j_default_planner().plan_grad_buckets(
            j_configs.get_reduced("glm4-9b"), mesh8,
            JCtx.from_mesh(mesh8, bucket_bytes=4096))
    assert _plan_records(seen[0]) == _plan_records(jplan)
    assert seen[0].buckets


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"bucket_bytes": 0},
                                   {"dp_backend": "flat"}],
                         ids=["default", "4KiB", "per-param", "flat"])
@pytest.mark.parametrize("arch", ("stablelm-3b", "glm4-9b"))
def test_reduction_logs_match_reference(arch, knobs, mesh8):
    """The bucketed (and per-parameter) reduction's OMPCCL call and byte
    logs equal the reference's ``reduce_gradients`` traced once in a
    ``shard_map`` over per-device gradients."""
    jcfg = j_configs.get_reduced(arch)
    jctx = JCtx.from_mesh(mesh8, **knobs)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    structs = {n: jax.ShapeDtypeStruct(s.shape, jnp.float32)
               for n, s in j_sch.build_schema(jcfg).items()}
    dp = jctx.dp_group.axes

    def body(g):
        g = j_ompccl.ensure_varying(g, dp)
        j_step.reduce_gradients(g, jcfg, jctx, pspecs=pspecs, mesh=mesh8)
        return jnp.zeros(())

    jdc = JContext(mesh=mesh8)
    with j_use_default(jdc):
        jax.eval_shape(shard_map(body, mesh=mesh8, in_specs=(pspecs,),
                                 out_specs=P()), structs)
    cfg = configs.get_reduced(arch)
    ctx = ParallelCtx.from_mesh(MESH, **knobs)
    specs = schema.partition_specs(cfg, MESH)
    grads = {n: stack_shards(np.zeros(s.shape, np.float32), MESH, specs[n])
             for n, s in schema.build_schema(cfg).items()}
    dc = DiompContext(mesh=MESH, device="cpu")
    with use_default(dc):
        reduce_gradients(grads, cfg, ctx, pspecs=specs, mesh=MESH)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    if ctx.bucket_bytes:        # ceil(partition bytes / bucket_bytes) each
        plan = bk.plan_for_config(cfg, MESH, ctx)
        parts = {}
        for b in plan.buckets:
            parts[(b.axes, b.dup)] = parts.get((b.axes, b.dup), 0) + b.nbytes
        calls = sum(-(-n // ctx.bucket_bytes) for n in parts.values())
        assert calls == len(plan.buckets) == sum(
            c.get("allreduce", 0) for c in dc.stats().values())


@pytest.mark.parametrize("block", [None, 64])
def test_int8_codes_and_scales_equal_reference(block):
    rng = np.random.RandomState(5)
    x = (rng.randn(16 * 64) * rng.rand(16 * 64) ** 3).astype(np.float32)
    x[:64] = 0.0                       # an all-zero block: scale 1
    q, s = comp.quantize_int8(torch.from_numpy(x), block=block)
    jq, js = j_comp.quantize_int8(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s, block=block).numpy(),
        np.asarray(j_comp.dequantize_int8(jq, js, block=block)))
    for n in (1000, 4096):
        assert comp.wire_bytes(n, codec="int8", block=block) == \
            j_comp.wire_bytes(n, codec="int8", block=block)


SHARDED = (("pod", "data", "model"), None)


@pytest.mark.parametrize("block", [None, 32], ids=["tensor", "block"])
def test_compressed_allreduce_error_feedback_matches_reference(block, mesh8):
    """Two steps of the int8 all-reduce over (pod, data) with the residual
    carried: every rank's mean and new residual, against the reference's
    (1e-6 of the payload's scale: f32 sums in another order)."""
    rng = np.random.RandomState(6)
    N = 8 * 4 * (block or 8) + (0 if block else 5)    # a padded tail too
    xs = [rng.randn(8, N).astype(np.float32) for _ in range(2)]

    def body(x, e):
        return j_comp.compressed_allreduce(
            x, JGroup(("pod", "data")), error=e, block=block)

    f = shard_map(body, mesh=mesh8, in_specs=(P(*SHARDED), P(*SHARDED)),
                  out_specs=(P(*SHARDED), P(*SHARDED)))
    je = np.zeros((8, N), np.float32)
    te = stack_shards(je, MESH, SHARDED)
    group = DiompGroup(("pod", "data"))
    for x in xs:
        jm, je = (np.asarray(a) for a in jax.jit(f)(x, je))
        tm, te = comp.compressed_allreduce(stack_shards(x, MESH, SHARDED),
                                           group, MESH, error=te, block=block)
        for got, want in ((tm, jm), (te, je)):
            np.testing.assert_allclose(unstack_shards(got, MESH, SHARDED),
                                       want, atol=1e-6 * np.abs(x).max())


def test_topk_allreduce_matches_reference(mesh8):
    rng = np.random.RandomState(7)
    x = rng.randn(8, 40).astype(np.float32)
    e0 = (rng.randn(8, 40) * 0.1).astype(np.float32)

    def body(x, e):
        return j_comp.topk_allreduce(x, JGroup(("pod", "data")), k=6, error=e)

    jm, je = shard_map(body, mesh=mesh8, in_specs=(P(*SHARDED),) * 2,
                       out_specs=(P(*SHARDED),) * 2)(x, e0)
    tm, te = comp.topk_allreduce(stack_shards(x, MESH, SHARDED),
                                 DiompGroup(("pod", "data")), MESH, k=6,
                                 error=stack_shards(e0, MESH, SHARDED))
    np.testing.assert_allclose(unstack_shards(tm, MESH, SHARDED),
                               np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(unstack_shards(te, MESH, SHARDED),
                               np.asarray(je), atol=1e-6)


def test_compressed_backend_reduces_a_sum():
    mesh = make_smoke_mesh(8)
    x = torch.randn(*mesh.sizes, 64)
    dc = DiompContext(mesh=mesh, device="cpu")
    group = DiompGroup(("pod", "data"))
    got = dc.communicator(group, "compressed").allreduce(x)
    want = dc.communicator(group, "flat").allreduce(x)
    assert float((got - want).abs().max()) <= 4 * 2 / 127 * float(
        x.abs().max())
    with pytest.raises(ValueError, match="op='sum' only"):
        dc.communicator(group, "compressed").allreduce(x, op="max")


def test_int8_weight_gather_matches_reference(mesh8):
    """The int8-wire ZeRO-3 gather and its straight-through gradient
    against the reference's ``_q8_gather`` custom VJP; the same logs."""
    rng = np.random.RandomState(8)
    spec = (("pod", "data"), "model")
    w = rng.randn(32, 8).astype(np.float32)
    gout = rng.randn(64, 8).astype(np.float32)
    jctx = JCtx.from_mesh(mesh8, gather_codec="int8")

    def body(w, gout):
        y, vjp = jax.vjp(lambda w: j_layers.gather_fsdp(w, jctx, dim=0), w)
        return y, vjp(gout)[0]

    jdc = JContext(mesh=mesh8)
    with j_use_default(jdc):
        jy, jg = jax.jit(shard_map(body, mesh=mesh8,
                                   in_specs=(P(*spec), P(*spec)),
                                   out_specs=(P(*spec), P(*spec))))(w, gout)
    ctx = ParallelCtx.from_mesh(MESH, gather_codec="int8")
    dc = DiompContext(mesh=MESH, device="cpu")
    tw = stack_shards(w, MESH, spec).requires_grad_()
    with use_default(dc):
        ty = Q8Gather.apply(tw, ctx, 0)
        ty.backward(stack_shards(gout, MESH, spec))
    np.testing.assert_allclose(unstack_shards(ty, MESH, spec),
                               np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(unstack_shards(tw.grad, MESH, spec),
                               np.asarray(jg), atol=1e-6)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree, np.float32)


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    """Three updates from the same parameters, gradients and state: the
    updates and the state within 1e-6 (f32 in another order)."""
    rng = np.random.RandomState(9)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4, 2), "d": (1, 9)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    lr, jlr = (optim.cosine_schedule(1e-2, warmup=1, total=5),
               j_optim.cosine_schedule(1e-2, warmup=1, total=5))
    opt, jopt = ((optim.adamw(lr), j_optim.adamw(jlr)) if name == "adamw"
                 else (optim.adafactor(lr), j_optim.adafactor(jlr)))
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    st, jst = opt.init(tp), jopt.init(jp)
    for i, g in enumerate(grads):
        u, st = opt.update({n: torch.from_numpy(v) for n, v in g.items()},
                           st, tp, i)
        ju, jst = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, jst,
                              jp, jnp.asarray(i))
        _assert_tree_close(_tree_np(u), _tree_np(ju), 1e-6)
        _assert_tree_close(_tree_np(st), _tree_np(jst), 1e-6)
    for s in range(6):
        assert abs(float(lr(s)) - float(jlr(jnp.asarray(s)))) <= 1e-9


def test_inplace_update_equals_functional():
    rng = np.random.RandomState(10)
    p = {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    for opt in (optim.adamw(lambda s: torch.tensor(1e-3)),
                optim.adafactor(lambda s: torch.tensor(1e-3))):
        st = opt.init(p)
        st2 = opt.init(p)
        u1, n1 = opt.update(g, st, p, 0)
        u2, n2 = opt.update(g, st2, p, 0, inplace=True)
        _assert_tree_close(_tree_np(u2), _tree_np(u1), 0)
        _assert_tree_close(_tree_np(st2), _tree_np(n1), 0)


def _sgd(lr):
    """Updates linear in the gradients, so parameters compare as grads."""
    def update(grads, state, params, step, inplace=False):
        return ({n: (-lr * g.float()).to(params[n].dtype)
                 for n, g in grads.items()}, state)
    return Optimizer(lambda p: {}, update, lambda s: {})


def _assert_update_close(got, want, start, what):
    """Two parameters after one linear update from ``start``: within 1e-5
    of the update's scale (f32 sums in another order) plus two f32 ulps of
    the parameter (each result is rounded to f32 at its own size)."""
    scale = float((want - start).abs().max())
    tol = 1e-5 * scale + 2 * torch.finfo(torch.float32).eps * float(
        want.abs().max())
    assert float((got - want).abs().max()) <= tol, what


def test_microbatch_overlap_equals_plain_accumulation(mesh8):
    """Microbatch 2 with the buckets reduce-scattered inside the loop (and
    all-gathered after it) gives the parameters of microbatch 2 without the
    overlap and of one whole batch (1e-6 of the update: f32 sums in
    another order); the overlapped run logs the reduce-scatter and
    all-gather pair where the others log all-reduces."""
    arch, dt = "glm4-9b", "f32"
    jp, _, _ = _reference(arch, dt, mesh8)
    cfg, tp = _port_params(arch, dt, jp)
    out = {}
    for tag, knobs in (("whole", {"microbatch": 1}),
                       ("plain", {"microbatch": 2,
                                  "overlap_grad_reduce": False}),
                       ("overlap", {"microbatch": 2})):
        ctx = ParallelCtx.from_mesh(MESH, remat=True, bucket_bytes=4096,
                                    **knobs)
        dc = DiompContext(mesh=MESH, device="cpu")
        with use_default(dc):
            step = build_train_step(cfg, MESH, ctx, _sgd(1.0), donate=False)
            p, _, m = step(tp, {}, _port_batch(cfg, dt, ctx), 0)
        out[tag] = (p, m, dc.stats())
    ref_p, ref_m, _ = out["whole"]
    for tag in ("plain", "overlap"):
        p, m, _ = out[tag]
        for n in ref_p:
            _assert_update_close(p[n], ref_p[n], tp[n], (tag, n))
        assert abs(float(m["loss"][0, 0, 0] - ref_m["loss"][0, 0, 0])) \
            <= 1e-6 * abs(float(ref_m["loss"][0, 0, 0]))
    ops = {op for calls in out["overlap"][2].values() for op in calls}
    assert {"reducescatter", "allgather"} <= ops


def test_built_step_logs_once(mesh8):
    """A built step logs its collectives on its first call only (the
    reference traces its jitted step once)."""
    jp, _, _ = _reference("stablelm-3b", "f32", mesh8)
    cfg, tp = _port_params("stablelm-3b", "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True, microbatch=2)
    dc = DiompContext(mesh=MESH, device="cpu")
    batch = _port_batch(cfg, "f32", ctx)
    with use_default(dc):
        step = build_train_step(cfg, MESH, ctx, _sgd(1e-3), donate=False)
        p, _, _ = step(tp, {}, batch, 0)
        once = (dc.stats(), dc.byte_stats())
        step(p, {}, batch, 1)
    assert (dc.stats(), dc.byte_stats()) == once
    assert sum(sum(c.values()) for c in once[0].values()) > 0


def test_explicit_equals_implicit_dp(mesh8):
    """The DiOMP explicit reduction and the implicit baseline (replicas
    summed as AD would, off the logs) give the same step; only the
    explicit one logs the DP all-reduces."""
    jp, _, _ = _reference("glm4-9b", "f32", mesh8)
    cfg, tp = _port_params("glm4-9b", "f32", jp)
    res = {}
    for explicit in (True, False):
        ctx = ParallelCtx.from_mesh(MESH, remat=False, explicit_dp=explicit)
        dc = DiompContext(mesh=MESH, device="cpu")
        with use_default(dc):
            step = build_train_step(cfg, MESH, ctx, _sgd(1.0), donate=False)
            res[explicit] = step(tp, {}, _port_batch(cfg, "f32", ctx), 0)[0], \
                dc.stats()
    for n in tp:
        _assert_update_close(res[True][0][n], res[False][0][n], tp[n], n)
    dp_groups = {group_for_axes(a).descriptor()
                 for a in (("pod", "data"), ("pod",))}
    assert dp_groups <= set(res[True][1])
    assert not dp_groups & set(res[False][1])


@pytest.mark.parametrize("arch", ["stablelm-3b", "paligemma-3b"])
def test_synthetic_batches_equal_reference(arch):
    cfg, jcfg = configs.get_reduced(arch), j_configs.get_reduced(arch)
    for step in (0, 3, 11):
        got = SyntheticLM(cfg, 4, 24, seed=17, shard=1).batch_at(step)
        want = JSyntheticLM(jcfg, 4, 24, seed=17, shard=1).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_losses_of_unported_families_name_their_items():
    """Every MoE family's loss is ported: deepseek-v3's (its MTP term
    included) and qwen3-moe's each score a batch, a finite loss replicated
    over "model"."""
    ctx = ParallelCtx.from_mesh(MESH)
    for arch in ("deepseek-v3-671b", "qwen3-moe-235b-a22b"):
        cfg = configs.get_reduced(arch)
        params = schema.init_params(cfg, MESH,
                                    torch.Generator().manual_seed(0),
                                    device="cpu")
        with use_default(DiompContext(mesh=MESH, device="cpu")), \
                torch.no_grad():
            loss = api.loss_fn(cfg)(params, _port_batch(cfg, "f32", ctx),
                                    cfg, ctx)
        assert loss.shape == MESH.sizes and bool(torch.isfinite(loss).all())
        assert torch.equal(loss, loss[..., :1].expand_as(loss)), arch


def test_launcher_trains_on_the_cpu(tmp_path, monkeypatch):
    """The launcher on the CPU with checkpoints.  The synthetic tokens are
    uniform, so a loss falls only where the model can memorize: every step
    here draws the pipeline's first batch."""
    from repro_torch.launch import train as launcher
    from repro_torch.core.context import reset_default_context

    first = SyntheticLM.batch_at
    monkeypatch.setattr(SyntheticLM, "batch_at",
                        lambda self, step: first(self, 0))
    try:
        run = launcher.main(["--arch", "stablelm-3b", "--reduced", "--steps",
                             "8", "--batch", "8", "--seq", "32", "--lr",
                             "5e-3", "--microbatch", "2", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "4"])
        assert run["losses"][-1] < run["losses"][0] - 0.05, run["losses"]
        assert all(np.isfinite(run["grad_norms"]))
        from repro_torch.train.checkpoint import CheckpointManager
        assert CheckpointManager(str(tmp_path)).steps() == [4, 8]
        # under chaos (every dispatch faults with probability 0.2, each
        # fault retried) the run's numbers are the calm run's, bit for bit
        chaos = launcher.main(["--arch", "stablelm-3b", "--reduced",
                               "--steps", "8", "--batch", "8", "--seq", "32",
                               "--lr", "5e-3", "--microbatch", "2",
                               "--device", "cpu", "--chaos-seed", "1",
                               "--chaos-p", "0.2"])
        assert chaos["losses"] == run["losses"]
        assert chaos["grad_norms"] == run["grad_norms"]
        plan = chaos["context"].fault_plan
        assert plan.injected and plan.unrecovered() == []
        assert sum(sum(ops.values()) for ops in
                   chaos["context"].retry_stats().values()) \
            == len(plan.injected)
        assert chaos["context"].stats() == run["context"].stats()
    finally:
        reset_default_context()


def test_remat_recompute_logs_against_the_forward_context(mesh8):
    """On the card the autograd engine runs the backward, and with it each
    checkpointed layer's recompute, in a thread of its own, where the
    caller's ``use_default`` scope is not seen.  The recompute must still
    run on the forward's mesh and log nothing: here the backward runs in
    another thread while the process default is a context of another
    mesh."""
    import threading

    from repro_torch.core.context import install_default, reset_default_context
    from repro_torch.launch.mesh import RankMesh

    jp, jloss, _ = _reference("stablelm-3b", "f32", mesh8)
    cfg, tp = _port_params("stablelm-3b", "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    other = install_default(DiompContext(mesh=RankMesh(("x",), (8,)),
                                         device="cpu"))
    try:
        names = sorted(tp)
        leaves = {n: tp[n].detach().requires_grad_(True) for n in names}
        dc = DiompContext(mesh=MESH, device="cpu")
        with use_default(dc):
            loss = api.loss_fn(cfg)(leaves, _port_batch(cfg, "f32", ctx),
                                    cfg, ctx)
        logged = dc.stats()
        out = {}

        def backward():
            try:
                out["grads"] = torch.autograd.grad(
                    loss.sum(), [leaves[n] for n in names])
            except Exception as exc:  # noqa: BLE001 - reported below
                out["error"] = exc

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        assert "error" not in out, out.get("error")
        assert len(out["grads"]) == len(names)
        assert dc.stats() == logged and other.stats() == {}
        assert abs(float(loss.detach().mean()) - jloss) <= 1e-5 * abs(jloss)
    finally:
        reset_default_context()


def test_train_lm_example_runs_on_the_cpu(tmp_path):
    """``repro_torch.examples.train_lm`` adds ``--reduced`` and trains with
    checkpoints."""
    from repro_torch.core.context import reset_default_context
    from repro_torch.examples import train_lm

    try:
        run = train_lm.main(["--arch", "glm4-9b", "--steps", "2", "--batch",
                             "8", "--seq", "16", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "2"])
    finally:
        reset_default_context()
    assert len(run["losses"]) == 2 and all(np.isfinite(run["losses"]))
    assert os.listdir(tmp_path) == ["step_00000002"]
