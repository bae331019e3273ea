"""The port's expert2d layout (MoE experts over model x data) held against
the JAX package's.

Under ``ParallelCtx.from_mesh(mesh, expert2d=True)`` each rank owns whole
experts at full d and ff, the dispatch all-to-all runs over the combined
("model", "data") EP group (its rank model-major) and no expert weight is
gathered.  Held here, on the CPU:

* the groups, ``ep_size`` and ``E_loc`` on the data 1 x model 4, data 2 x
  model 2, data 4 x model 2 and pod 2 x data 2 x model 2 meshes (the EP
  group excludes "pod"), the placement specs of reduced qwen3-moe and
  deepseek-v3 against the reference's, and each rank holding the experts
  of its own EP rank;
* ``moe_block`` in the a2a and replicated regimes (the replicated one with
  its all-gather over "data" where data > 1), with and without shared
  experts, and at a capacity that drops, on those meshes, against the
  reference's ``moe_block`` in ``shard_map`` with f32 weights: within 1e-5
  of the output's scale (``tests/test_torch_moe_model.py``'s bound), the
  same drop count, every rank's expert choices equal to ``lax.top_k`` of
  the router's probabilities on the same tokens, and equal call and byte
  logs;
* reduced deepseek-v3 (capacity factor 4.0, as the reference's own
  expert2d test) and reduced qwen3-moe: the loss and every gradient leaf
  against ``jax.value_and_grad`` of the reference's loss in a test-built
  ``shard_map`` (``tests/test_torch_train.py``'s f32 bounds: the loss 1e-5
  relative, each leaf 1e-4 of its largest value);
* the port's expert2d against its own default layout, the reference test's
  assertions (``tests/test_models.py::test_expert2d_exact_and_trains``):
  the losses within 1e-3, four AdamW steps' losses within 2e-2, the last at
  least 0.1 below the first;
* the bucket plan, the reduction's call and byte logs, Adafactor's dim
  axes and the optimizer state's specs against the reference's;
* a checkpoint saved under expert2d restored bit for bit, and the next step
  from it bit for bit the uninterrupted run's;
* reduced qwen3-moe served: the decode step (the replicated regime and
  the a2a regime) and the prefill step against the reference's steps
  (logits within 1e-5 of their scale, equal logs), and the engine's
  greedy tokens under expert2d equal to the default layout's.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.backends import ensure_varying
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import default_context as j_default_context
from repro.core.context import use_default as j_use_default
from repro.distributed import buckets as j_bk
from repro.distributed.sharding import rules_for_ctx as j_rules_for_ctx
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ParallelCtx as JCtx
from repro.serve import step as j_step
from repro.train import optim as j_optim
from repro.train import step as j_train

from repro_torch import configs
from repro_torch.core.backends import group_rank
from repro_torch.core.context import DiompContext, use_default
from repro_torch.distributed import buckets as bk
from repro_torch.distributed.sharding import rules_for_ctx
from repro_torch.interop import (params_from_reference, stack_shards,
                                 unstack_shards)
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.train import from_global, to_global
from repro_torch.models import api, schema
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, ParallelCtx
from repro_torch.serve import step as t_step
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optim
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import (build_train_step, opt_state_specs,
                                    per_rank_grads, reduce_gradients)

from test_torch_models import S as SERVE_S
from test_torch_models import _Both, _np, _padded, _tokens
from test_torch_moe_model import _moe_cfg, _moe_lp
from test_torch_train import B, S, _batch, _plan_records
from test_torch_train import MESH as MESH8

MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (make_mesh(shape, axes, axis_types="auto"),
            RankMesh(axes, shape))


def _batch_axes(axes):
    return tuple(a for a in ("pod", "data") if a in axes)


# -- groups, sizes and specs ------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_groups_sizes_and_specs_equal_reference(mesh_id, arch):
    jmesh, mesh = _meshes(mesh_id)
    ctx = ParallelCtx.from_mesh(mesh, expert2d=True)
    jctx = JCtx.from_mesh(jmesh, expert2d=True)
    for f in ("tp", "fsdp", "dp", "pods", "ep_size"):
        assert getattr(ctx, f) == getattr(jctx, f), f
    for g in ("tp_group", "fsdp_group", "dp_group", "ep_group", "world"):
        mine, ref = getattr(ctx, g), getattr(jctx, g)
        assert (mine.axes, mine.name) == (ref.axes, ref.name), g
    assert ctx.ep_group.axes == ("model", "data")
    assert ctx.ep_size == mesh.shape["model"] * mesh.shape["data"]
    cfg, jcfg = configs.get_reduced(arch), j_configs.get_reduced(arch)
    E_loc = cfg.num_experts // ctx.ep_size
    rules = rules_for_ctx(ctx)
    specs = schema.partition_specs(cfg, mesh, rules)
    jspecs = j_sch.partition_specs(jcfg, jmesh, j_rules_for_ctx(jctx))
    build = schema.build_schema(cfg)
    for name, spec in specs.items():
        assert spec == _padded(jspecs[name], len(build[name].shape)), name
    for name in ("layers/w_gate_e", "layers/w_up_e", "layers/w_down_e"):
        assert specs[name] == (None, ("model", "data"), None, None), name
    # each rank holds the experts of its own EP rank (model-major)
    L, E = build["layers/w_gate_e"].shape[:2]
    ids = np.broadcast_to(np.arange(E, dtype=np.float32)[None, :, None, None],
                          build["layers/w_gate_e"].shape)
    held = stack_shards(ids, mesh, specs["layers/w_gate_e"])
    r = group_rank(ctx.ep_group, mesh)
    assert held.shape[mesh.ndim + 1] == E_loc
    want = r[..., None] * E_loc + torch.arange(E_loc)
    assert torch.equal(held[..., 0, :, 0, 0].long(), want)
    # the model-major rank: model index times data's size plus data index
    dm, dd = mesh.dim("model"), mesh.dim("data")
    idx = np.indices(mesh.sizes)
    assert np.array_equal(r.numpy(), idx[dm] * mesh.shape["data"] + idx[dd])


# -- moe_block ----------------------------------------------------------------------

CASES = {"a2a": dict(b=2, T=16), "a2a_shared": dict(b=2, T=16, shared=1),
         "a2a_tight": dict(b=4, T=32, cf=1.0),
         "replicated": dict(b=1, T=1, inference=True),
         "replicated_shared": dict(b=1, T=1, shared=1, inference=True)}


def _specs(lp, axes):
    espec = (("model", "data"), None, None)
    specs = {"router": (None, None), "w_gate_e": espec, "w_up_e": espec,
             "w_down_e": espec}
    if "w_gate_s" in lp:          # ZeRO-3 over "data", TP over "model"
        specs.update({"w_gate_s": ("data", "model"),
                      "w_up_s": ("data", "model"),
                      "w_down_s": ("model", "data")})
    return specs


def _ref_block(jmesh, cfg, lp, x, inference):
    ctx = JCtx.from_mesh(jmesh, expert2d=True, inference=inference)
    axes = tuple(jmesh.axis_names)
    bx = _batch_axes(axes)
    jspecs = {k: P(*v) for k, v in _specs(lp, axes).items()}

    def f(xx, pp):
        with j_default_context().dispatch_stats.collect() as ds:
            out = j_layers.moe_block(xx, pp, cfg, ctx)
        return (lax.pmean(out, "model"),
                lax.psum(ensure_varying(ds["moe_dropped"], axes), axes))

    jdc = JContext(mesh=jmesh)
    with j_use_default(jdc):
        out, dropped = jax.jit(shard_map(
            f, mesh=jmesh, in_specs=(P(bx), jspecs),
            out_specs=(P(bx), P())))(x, lp)
    return np.asarray(out), float(dropped), jdc


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_moe_block_matches_reference(mesh_id, case, monkeypatch):
    jmesh, mesh = _meshes(mesh_id)
    kw = CASES[case]
    E = 8
    jcfg, cfg = (_moe_cfg(c, E, kw.get("shared", 0), kw.get("cf", 8.0))
                 for c in (JModelConfig, ModelConfig))
    lp = _moe_lp(jcfg)
    nb = int(np.prod([mesh.shape[a] for a in _batch_axes(mesh.axis_names)]))
    x = np.random.RandomState(3).randn(nb * kw["b"], kw["T"], 32).astype(
        np.float32)
    want, d_ref, jdc = _ref_block(jmesh, jcfg, lp, x,
                                  kw.get("inference", False))
    ctx = ParallelCtx.from_mesh(mesh, expert2d=True,
                                inference=kw.get("inference", False))
    specs = _specs(lp, mesh.axis_names)
    tlp = {k: stack_shards(v, mesh, specs[k]) for k, v in lp.items()}
    routes = []
    route = tl.route_topk

    def tapped(toks, router, k):
        top_w, top_e = route(toks, router, k)
        routes.append((toks.clone(), top_e.clone()))
        return top_w, top_e
    monkeypatch.setattr(tl, "route_topk", tapped)
    xspec = (_batch_axes(mesh.axis_names), None, None)
    dc = DiompContext(mesh=mesh, device="cpu")
    with use_default(dc), dc.dispatch_stats.collect() as ds:
        out = tl.moe_block(stack_shards(x, mesh, xspec), tlp, cfg, ctx)
    dropped = float(ds["moe_dropped"].sum())
    # the reference's pmean over "model": every model rank holds the rows
    m = mesh.dim("model")
    got = unstack_shards(out.mean(m, keepdim=True).expand_as(out), mesh,
                         xspec)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    assert dropped == d_ref
    assert (dropped > 0) == (case == "a2a_tight")
    # every rank's expert choices: lax.top_k of the router's probabilities
    (toks, top_e), = routes
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(toks.numpy()),
                                   jnp.asarray(lp["router"])), axis=-1)
    np.testing.assert_array_equal(
        top_e.numpy(), np.asarray(lax.top_k(probs, jcfg.experts_per_token)[1]))
    t_loc = kw["b"] * kw["T"]
    if case.startswith("replicated"):
        t_loc *= mesh.shape["data"]
    else:
        t_loc //= mesh.shape["model"]
    assert toks.shape[mesh.ndim] == t_loc
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    ep = ctx.ep_group.descriptor()
    verb = "allreduce" if case.startswith("replicated") else "alltoall"
    assert dc.stats()[ep][verb] == (1 if verb == "allreduce" else 2)


# -- loss and gradients -------------------------------------------------------------

def _cf(cfg, cf=4.0):
    """The reference test's ample capacity: nothing drops, so both layouts
    route identically."""
    return dataclasses.replace(cfg, capacity_factor=cf)


def _ref_grads(arch, mesh8):
    """The reference's weights, mean loss and DP-reduced gradients under
    expert2d (global view), from ``jax.value_and_grad`` of its loss."""
    jcfg = _cf(j_configs.get_reduced(arch))
    jp = {k: v.astype(jnp.float32) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    jctx = JCtx.from_mesh(mesh8, remat=True, expert2d=True)
    pspecs = j_sch.partition_specs(jcfg, mesh8, j_rules_for_ctx(jctx))
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    dp = jctx.dp_group.axes
    loss_fn = j_api.loss_fn(jcfg)

    def body(params, batch):
        p = j_ompccl.ensure_varying(params, dp)
        loss, g = jax.value_and_grad(
            lambda q: loss_fn(q, batch, jcfg, jctx))(p)
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
        loss, grads = jax.jit(f)(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    return jp, float(loss), {n: _np(g) for n, g in grads.items()}


def _port_batch(cfg, ctx, seed=0):
    _, bspecs = api.batch_structs(cfg, MESH8, B, S, dp_axes=ctx.dp_axes)
    return {k: stack_shards(v, MESH8, bspecs[k])
            for k, v in _batch(cfg, seed).items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(arch, mesh8):
    jp, jloss, jgrads = _ref_grads(arch, mesh8)
    cfg = _cf(configs.get_reduced(arch))
    ctx = ParallelCtx.from_mesh(MESH8, remat=True, expert2d=True)
    rules = rules_for_ctx(ctx)
    tp = params_from_reference(cfg, MESH8, {k: _np(v) for k, v in jp.items()},
                               dtype=torch.float32, rules=rules)
    with use_default(DiompContext(mesh=MESH8, device="cpu")):
        loss, grads = per_rank_grads(tp, _port_batch(cfg, ctx), cfg, ctx,
                                     MESH8)
        red, _ = reduce_gradients(grads, cfg, ctx, mesh=MESH8)
    assert abs(float(loss.mean()) - jloss) <= 1e-5 * abs(jloss)
    specs = schema.partition_specs(cfg, MESH8, rules)
    assert sorted(red) == sorted(jgrads)
    for n, want in jgrads.items():
        got = unstack_shards(red[n], MESH8, specs[n])
        assert np.abs(want).max() > 0, n
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert2d_exact_and_trains_as_the_default_layout(arch):
    """The reference test's assertions, on the port: one forward's loss
    within 1e-3 of the default layout's, four AdamW steps' losses within
    2e-2, and the last loss at least 0.1 below the first."""
    cfg = _cf(configs.get_reduced(arch))
    losses, hists = {}, {}
    for e2d in (False, True):
        ctx = ParallelCtx.from_mesh(MESH8, remat=True, expert2d=e2d)
        with use_default(DiompContext(mesh=MESH8, device="cpu")):
            params = schema.init_params(cfg, MESH8,
                                        torch.Generator().manual_seed(0),
                                        device="cpu", rules=rules_for_ctx(ctx))
            batch = _port_batch(cfg, ctx, seed=1)
            with torch.no_grad():
                losses[e2d] = float(api.loss_fn(cfg)(params, batch, cfg,
                                                     ctx).mean())
            opt = optim.adamw(optim.cosine_schedule(5e-3, warmup=2,
                                                    total=40))
            step = build_train_step(cfg, MESH8, ctx, opt, donate=False)
            state = opt.init(params)
            hist = []
            for i in range(4):
                params, state, m = step(params, state, batch, i)
                hist.append(float(m["loss"].reshape(-1)[0]))
        hists[e2d] = hist
    assert abs(losses[False] - losses[True]) < 1e-3, losses
    np.testing.assert_allclose(hists[False], hists[True], atol=2e-2)
    assert hists[True][-1] < hists[True][0] - 0.1, hists


# -- the reduction, the optimizers' specs, the checkpoint ---------------------------

@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"bucket_bytes": 4096,
                                    "grad_codec": "int8"}],
                         ids=["default", "4KiB", "4KiB-int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bucket_plan_equals_reference(arch, knobs, mesh8):
    """The expert leaves leave the "data" reduction: each bucket reduces
    over the DP axes its leaves' specs leave unused, record for record."""
    cfg = configs.get_reduced(arch)
    plan = bk.plan_for_config(cfg, MESH8, ParallelCtx.from_mesh(
        MESH8, expert2d=True, **knobs))
    jplan = j_bk.plan_for_config(j_configs.get_reduced(arch), mesh8,
                                 JCtx.from_mesh(mesh8, expert2d=True,
                                                **knobs))
    assert _plan_records(plan) == _plan_records(jplan)
    assert plan.total_bytes() == jplan.total_bytes()
    default = bk.plan_for_config(cfg, MESH8, ParallelCtx.from_mesh(
        MESH8, **knobs))
    assert _plan_records(plan) != _plan_records(default)


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 0},
                                   {"dp_backend": "flat"}],
                         ids=["default", "per-leaf", "flat"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduction_logs_match_reference(arch, knobs, mesh8):
    """``reduce_gradients``' call and byte logs under expert2d against the
    reference's traced once in a ``shard_map``."""
    jcfg = j_configs.get_reduced(arch)
    jctx = JCtx.from_mesh(mesh8, expert2d=True, **knobs)
    pspecs = j_sch.partition_specs(jcfg, mesh8, j_rules_for_ctx(jctx))
    structs = {n: jax.ShapeDtypeStruct(s.shape, jnp.float32)
               for n, s in j_sch.build_schema(jcfg).items()}
    dp = jctx.dp_group.axes

    def body(g):
        g = j_ompccl.ensure_varying(g, dp)
        j_train.reduce_gradients(g, jcfg, jctx, pspecs=pspecs, mesh=mesh8)
        return jnp.zeros(())

    jdc = JContext(mesh=mesh8)
    with j_use_default(jdc):
        jax.eval_shape(shard_map(body, mesh=mesh8, in_specs=(pspecs,),
                                 out_specs=P()), structs)
    cfg = configs.get_reduced(arch)
    ctx = ParallelCtx.from_mesh(MESH8, expert2d=True, **knobs)
    specs = schema.partition_specs(cfg, MESH8, rules_for_ctx(ctx))
    grads = {n: stack_shards(np.zeros(s.shape, np.float32), MESH8, specs[n])
             for n, s in schema.build_schema(cfg).items()}
    dc = DiompContext(mesh=MESH8, device="cpu")
    with use_default(dc):
        reduce_gradients(grads, cfg, ctx, pspecs=specs, mesh=MESH8)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    assert sum(sum(c.values()) for c in dc.stats().values()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_optimizer_specs_equal_reference(arch, mesh8):
    """Adafactor's dim axes and both optimizers' state specs under the
    expert2d rules: the expert weights' factored dims reduce over nothing."""
    cfg, jcfg = configs.get_reduced(arch), j_configs.get_reduced(arch)
    rules = rules_for_ctx(ParallelCtx.from_mesh(MESH8, expert2d=True))
    jrules = j_rules_for_ctx(JCtx.from_mesh(mesh8, expert2d=True))
    build = schema.build_schema(cfg)
    axes = optim.adafactor_dim_axes(cfg, MESH8, rules)
    assert axes == j_optim.adafactor_dim_axes(jcfg, mesh8, jrules)
    assert axes["layers/w_gate_e"] == ((), ())
    for name in ("adamw", "adafactor"):
        mine = opt_state_specs(cfg, MESH8, name, rules)
        ref = j_train.opt_state_specs(jcfg, mesh8, name, jrules)
        for key, tree in mine.items():
            for leaf, spec in tree.items():
                want = ref[key][leaf]
                rank = (len(build[leaf].shape) if name == "adamw" else
                        len(build[key].shape) - (leaf in ("vr", "vc")))
                assert spec == _padded(want, rank), (name, key, leaf)


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    """Two Adafactor steps of reduced qwen3-moe under expert2d, a
    checkpoint, a third step; the checkpoint restored gives the saved
    state bit for bit, and the third step from it the uninterrupted run's."""
    cfg = configs.get_reduced(MOE_ARCHS[0])
    ctx = ParallelCtx.from_mesh(MESH8, remat=True, expert2d=True)
    rules = rules_for_ctx(ctx)
    pspecs = schema.partition_specs(cfg, MESH8, rules)
    ospecs = opt_state_specs(cfg, MESH8, "adafactor", rules)
    ckpt = CheckpointManager(str(tmp_path))
    lr = optim.cosine_schedule(1e-3, warmup=1, total=10)
    opt = optim.adafactor(lr, dim_axes=optim.adafactor_dim_axes(
        cfg, MESH8, rules), nd=MESH8.ndim)
    with use_default(DiompContext(mesh=MESH8, device="cpu")):
        step = build_train_step(cfg, MESH8, ctx, opt,
                                optimizer_name="adafactor", donate=False)
        p = schema.init_params(cfg, MESH8, torch.Generator().manual_seed(0),
                               device="cpu", rules=rules)
        st = opt.init(p)
        batches = [_port_batch(cfg, ctx, seed) for seed in range(3)]
        for i in range(2):
            p, st, _ = step(p, st, batches[i], i)
        ckpt.save(2, to_global(p, pspecs, MESH8),
                  to_global(st, ospecs, MESH8), blocking=True)
        p_a, st_a, _ = step(p, st, batches[2], 2)
        s, gp, gs, _ = ckpt.restore()
        p_r = from_global(gp, pspecs, MESH8, "cpu")
        st_r = from_global(gs, ospecs, MESH8, "cpu")
        assert s == 2
        assert all(torch.equal(p_r[n], p[n]) for n in p)
        assert all(torch.equal(st_r[n][k], st[n][k])
                   for n in st for k in st[n])
        p_b, st_b, _ = step(p_r, st_r, batches[2], 2)
    assert all(torch.equal(p_a[n], p_b[n]) for n in p_a)
    assert all(torch.equal(st_a[n][k], st_b[n][k])
               for n in st_a for k in st_a[n])


# -- serving ---------------------------------------------------------------------------

class _Served(_Both):
    """Reduced qwen3-moe in both packages under expert2d, f32 weights."""

    def __init__(self, mesh8):
        super().__init__(MOE_ARCHS[0], "f32", mesh8)
        self.jctx = JCtx.from_mesh(mesh8, remat=False, inference=True,
                                   expert2d=True)
        self.ctx = ParallelCtx.from_mesh(MESH8, remat=False, inference=True,
                                         expert2d=True)
        self.tp = params_from_reference(
            self.cfg, MESH8, {k: _np(v) for k, v in self.jp.items()},
            dtype=torch.float32, rules=rules_for_ctx(self.ctx))


@pytest.mark.parametrize("Bd", [4, 8], ids=["replicated", "a2a"])
def test_decode_matches_reference(Bd, mesh8, monkeypatch):
    """Decode steps with per-slot positions: 4 slots put one token a data
    rank (the replicated regime, its tokens all-gathered over "data"), 8
    slots two (the a2a regime over the combined group).  One built step
    logs its collectives once, as one trace of the reference's."""
    sv = _Served(mesh8)
    regimes = []
    block = tf.moe_block

    def tapped(x, lp, cfg, ctx):
        regimes.append(x.shape[MESH8.ndim] * x.shape[MESH8.ndim + 1])
        return block(x, lp, cfg, ctx)
    monkeypatch.setattr(tf, "moe_block", tapped)
    rng = np.random.RandomState(3)
    js = j_step.build_decode_step(sv.jcfg, mesh8, sv.jctx, B=Bd, S=SERVE_S,
                                  donate=False, slot_pos=True)
    ts = t_step.build_decode_step(sv.cfg, MESH8, sv.ctx, B=Bd, S=SERVE_S,
                                  slot_pos=True)
    jc, tc = sv.caches(Bd, ts, rng=rng,
                       pos=rng.randint(0, SERVE_S - 4, Bd).astype(np.int32))
    trace = JContext(mesh=mesh8)
    toks = _tokens(rng, (Bd, 1), sv.cfg)
    with j_use_default(trace):
        jax.eval_shape(js, sv.jp, toks, jc)
    for _ in range(2):
        toks = _tokens(rng, (Bd, 1), sv.cfg)
        res = sv.run(js, ts, (sv.jp, toks, jc),
                     (sv.tp, stack_shards(toks, MESH8, ts.token_spec), tc))
        sv.check(*res, ts)
        jc, tc = res[1], res[3]
    # tokens a rank reaching moe_block: under 2 (the model ranks) at 4 slots
    assert set(regimes) == {Bd // 4}
    assert sv.dc.stats() == trace.stats()
    assert sv.dc.byte_stats() == trace.byte_stats()
    fsdp = sv.ctx.fsdp_group.descriptor()
    ep = sv.ctx.ep_group.descriptor()
    if Bd == 4:
        assert trace.stats()[ep] == {"allreduce": 1}     # one layer body
        assert trace.stats()[fsdp]["allgather"] > 0
    else:
        assert trace.stats()[ep] == {"alltoall": 2}


def test_prefill_matches_reference(mesh8):
    sv = _Served(mesh8)
    toks = _tokens(np.random.RandomState(1), (4, 8), sv.cfg)
    js = j_step.build_prefill_step(sv.jcfg, mesh8, sv.jctx, B=4, S_prompt=8,
                                   S_cache=SERVE_S, donate=False)
    ts = t_step.build_prefill_step(sv.cfg, MESH8, sv.ctx, B=4,
                                   S_cache=SERVE_S)
    jc, tc = sv.caches(4, ts)
    res = sv.run(js, ts, (sv.jp, toks, jc),
                 (sv.tp, stack_shards(toks, MESH8, ts.token_spec), tc))
    sv.check(*res, ts)
    assert sv.dc.stats() == sv.jdc.stats()
    assert sv.dc.byte_stats() == sv.jdc.byte_stats()


@pytest.mark.parametrize("slots", [4, 2], ids=["a2a", "replicated"])
def test_engine_tokens_equal_the_default_layout(slots):
    """Reduced qwen3-moe served on data 2 x model 2, f32, greedy: under
    expert2d the same tokens as under the default layout, chunked prefill
    included; at 2 slots the decodes take the replicated regime."""
    mesh = RankMesh(("data", "model"), (2, 2))
    cfg = configs.get_reduced(MOE_ARCHS[0])
    glob = {k: _np(v) for k, v in j_sch.init_params(
        j_configs.get_reduced(MOE_ARCHS[0]), jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 9, 17, 5, 26, 12)]
    outs = {}
    for e2d in (False, True):
        ctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                    expert2d=e2d)
        params = params_from_reference(cfg, mesh, glob, dtype=torch.float32,
                                       rules=rules_for_ctx(ctx))
        eng = ServeEngine(cfg, mesh, ctx, params, context=DiompContext(
            mesh=mesh, device="cpu", segment_bytes=1 << 26,
            allocator="buddy"), slots=slots, max_len=64, prefill_chunk=8)
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run()
        assert all(r.done and len(r.out) == 5 for r in reqs)
        outs[e2d] = [list(r.out) for r in reqs]
        if e2d:
            ep = ctx.ep_group.descriptor()
            assert eng.dctx.stats()[ep]
    assert outs[True] == outs[False]
