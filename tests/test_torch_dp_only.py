"""The port's ``dp_only`` layout held against the JAX package's.

``dp_only`` drops tensor parallelism: ``tp = 1``, the "model" axis joins
the data-parallel domain (``dp_all`` over pod, data and model), the batch
splits over every axis, and every weight rule that could only pick
"model" is replicated (``DP_ONLY_RULES``).  The reference's layout for
small dense models whose TP all-reduces dominate.  Held here, on the
8-rank smoke mesh (pod 2 x data 2 x model 2, the reference's ``mesh8``):
the context's fields and groups; the rules' specs for stablelm-3b and
hubert-xlarge (smoke and production meshes); reduced stablelm-3b's loss
and every gradient leaf against ``jax.value_and_grad`` in a test-built
``shard_map`` (f32 loss 1e-5 relative, gradients 1e-4 of each leaf's
largest value; bf16 1e-3 and 2e-2); the gradient reduction's call and
byte logs against the reference's ``reduce_gradients`` traced over
``dp_all``; and six steps of the port's train step lowering the loss by
0.1, as the reference's ``test_dp_only_layout_trains`` asks.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.compat import shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.distributed import sharding as j_sharding
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.train import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.distributed import buckets as bk
from repro_torch.distributed import sharding
from repro_torch.interop import params_from_reference, stack_shards
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import api, schema
from repro_torch.models.config import ParallelCtx
from repro_torch.train import optim
from repro_torch.train.step import build_train_step, reduce_gradients

from test_torch_audio import (B, DTYPES, S, _np, _padded, assert_grads_close,
                              pipeline_batch, port_grads, ref_params,
                              reference_grads)

MESH = make_smoke_mesh(8)
ARCHS = ("stablelm-3b", "hubert-xlarge")


def _groups(ctx):
    """Each group of the context as (axes, name); None where absent."""
    return {n: None if g is None else (tuple(g.axes), g.name) for n, g in (
        ("tp", ctx.tp_group), ("fsdp", ctx.fsdp_group),
        ("dp", ctx.dp_group), ("ep", ctx.ep_group), ("world", ctx.world),
        ("pod", ctx.pod_group))}


@pytest.mark.parametrize("shape", [("pod2-data2-model2", (2, 2, 2)),
                                   ("data4-model2", (4, 2))],
                         ids=lambda s: s[0])
def test_from_mesh_fields_and_groups_equal_reference(shape):
    from repro.core.compat import make_mesh
    from repro_torch.launch.mesh import RankMesh

    sizes = shape[1]
    axes = ("pod", "data", "model")[-len(sizes):]
    jmesh = make_mesh(sizes, axes, axis_types="auto")
    mesh = RankMesh(axes, sizes)
    ctx = ParallelCtx.from_mesh(mesh, remat=True, layout="dp_only")
    jctx = JCtx.from_mesh(jmesh, remat=True, layout="dp_only")
    assert (ctx.tp, ctx.fsdp, ctx.dp, ctx.pods) == \
        (jctx.tp, jctx.fsdp, jctx.dp, jctx.pods)
    assert ctx.tp == 1 and ctx.dp == int(np.prod(sizes))
    assert _groups(ctx) == _groups(jctx)
    assert ctx.dp_group.name == "dp_all" and ctx.dp_axes == axes
    assert ctx.tp_group.axes == () == ctx.ep_group.axes
    assert ctx.layout == "dp_only"
    with pytest.raises(ValueError, match="layout"):
        ParallelCtx.from_mesh(mesh, layout="pipeline")


def test_rules_table_equals_reference():
    assert sharding.DP_ONLY_RULES.rules == j_sharding.DP_ONLY_RULES.rules
    ctx = ParallelCtx.from_mesh(MESH, layout="dp_only")
    assert sharding.rules_for_ctx(ctx) is sharding.DP_ONLY_RULES


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_reference(arch, full, mesh8):
    cfg = (configs.get if full else configs.get_reduced)(arch)
    jcfg = (j_configs.get if full else j_configs.get_reduced)(arch)
    shapes = schema.build_schema(cfg)
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16})
    for tmesh, jmesh in ((MESH, mesh8), (make_production_mesh(), prod)):
        specs = schema.partition_specs(cfg, tmesh, sharding.DP_ONLY_RULES)
        jspecs = j_sch.partition_specs(jcfg, jmesh, j_sharding.DP_ONLY_RULES)
        for name, spec in specs.items():
            assert spec == _padded(jspecs[name], len(shapes[name].shape)), \
                name
            assert "model" not in bk.spec_axes(spec), name
    structs, bspecs = api.batch_structs(
        cfg, MESH, B, S, dp_axes=("pod", "data", "model"))
    assert all(s[0] == ("pod", "data", "model") for s in bspecs.values())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dt, mesh8):
    """Reduced stablelm-3b (and hubert) with the batch over all eight
    ranks and every weight replicated over "model"."""
    _, _, _, ltol, gtol = DTYPES[dt]
    batch = pipeline_batch(configs.get_reduced(arch))
    jp, jloss, jgrads = reference_grads(arch, dt, mesh8, batch,
                                        layout="dp_only")
    loss, grads = port_grads(arch, dt, jp, batch, layout="dp_only")
    assert abs(loss - jloss) <= ltol * abs(jloss)
    assert_grads_close(grads, jgrads, gtol)


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"bucket_bytes": 0},
                                   {"dp_backend": "flat"},
                                   {"bucket_bytes": 4096,
                                    "grad_codec": "int8"}],
                         ids=["default", "4KiB", "per-param", "flat",
                              "4KiB-int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduction_logs_match_reference(arch, knobs, mesh8):
    """The reduction over ``dp_all`` (pod, data, model): the buckets'
    groups now include "model", the hierarchical backend takes those that
    span pods, and the int8 codec those over the whole DP group; the call
    and byte logs equal the reference's ``reduce_gradients`` traced once
    in a ``shard_map`` (the codec is not a communicator call in either)."""
    jcfg = j_configs.get_reduced(arch)
    jctx = JCtx.from_mesh(mesh8, layout="dp_only", **knobs)
    pspecs = j_sch.partition_specs(jcfg, mesh8, j_sharding.DP_ONLY_RULES)
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
    ctx = ParallelCtx.from_mesh(MESH, layout="dp_only", **knobs)
    specs = schema.partition_specs(cfg, MESH, sharding.DP_ONLY_RULES)
    grads = {n: stack_shards(np.zeros(s.shape, np.float32), MESH, specs[n])
             for n, s in schema.build_schema(cfg).items()}
    dc = DiompContext(mesh=MESH, device="cpu")
    with use_default(dc):
        reduce_gradients(grads, cfg, ctx, pspecs=specs, mesh=MESH)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    if ctx.bucket_bytes:
        plan = bk.plan_for_config(cfg, MESH, ctx)
        assert {b.axes for b in plan.buckets} <= {("pod", "model"),
                                                  ("pod", "data", "model")}
        assert any("model" in b.axes for b in plan.buckets)


def test_six_steps_lower_the_loss():
    """The reference's ``test_dp_only_layout_trains`` on the port: reduced
    stablelm-3b, dp 8, AdamW under a cosine schedule, one batch six times;
    the loss falls by more than 0.1, and every step's metrics agree over
    the eight ranks."""
    cfg = configs.get_reduced("stablelm-3b")
    ctx = ParallelCtx.from_mesh(MESH, remat=True, layout="dp_only")
    assert ctx.tp == 1 and ctx.dp == 8
    jp = ref_params("stablelm-3b", "f32")
    rules = sharding.rules_for_ctx(ctx)
    params = params_from_reference(cfg, MESH, {k: _np(v)
                                               for k, v in jp.items()},
                                   dtype=torch.bfloat16, rules=rules)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (8, 16)).astype(np.int32)
    _, bspecs = api.batch_structs(cfg, MESH, 8, 16, dp_axes=ctx.dp_axes)
    batch = {"tokens": stack_shards(toks, MESH, bspecs["tokens"])}
    opt = optim.adamw(optim.cosine_schedule(5e-3, warmup=2, total=40))
    losses = []
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        step = build_train_step(cfg, MESH, ctx, opt, donate=False)
        o = opt.init(params)
        for i in range(6):
            params, o, m = step(params, o, batch, i)
            loss = m["loss"]
            assert torch.all(loss == loss.reshape(-1)[0])
            losses.append(float(loss.reshape(-1)[0]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, losses
