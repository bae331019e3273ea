"""deepseek-v3's training slice held against the JAX package.

* reduced deepseek-v3's loss (the main CE plus 0.1 times its
  multi-token-prediction term) and every gradient leaf, the MLA attention
  of its leading dense layer, its MoE layers, its shared experts and the 15
  ``mtp/`` leaves, against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` on the 8-rank smoke mesh (``tests/test_torch_train.py``'s f32
  bounds: the loss 1e-5 relative, each leaf 1e-4 of its largest value).
  Only f32, as for qwen3-moe (``tests/test_torch_moe_train.py``): a bf16
  forward flips routing ties the reference's does not;
* the MTP term alone: the loss less the main CE, against the reference's
  loss less its own main CE (the same two functions on the same weights);
* ``moe_dropped`` and ``moe_drop_rate`` of a built step against the
  reference's ``moe_block`` stats summed over layers and microbatches: the
  MTP layer is dense and adds none;
* the loss's forward and backward log what one ``jax.eval_shape`` trace of
  ``value_and_grad`` of the reference's loss logs, and the bucket plan over
  deepseek's tree equals the reference's ``plan_for_config``;
* the launcher trains reduced deepseek-v3 on the CPU, its loss falling.
"""

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
from repro.core.context import default_context as j_default_context
from repro.core.context import use_default as j_use_default
from repro.distributed import buckets as j_bk
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.train import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.distributed import buckets as bk
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.models import api, schema
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tf
from repro_torch.models.config import ParallelCtx
from repro_torch.train.step import (build_train_step, per_rank_grads,
                                    reduce_gradients)

from test_torch_train import (B, MESH, S, _batch, _plan_records,
                              _port_batch, _port_params, _reference, _sgd)

ARCH = "deepseek-v3-671b"
F32 = jnp.float32


@pytest.fixture(scope="module")
def ref(mesh8):
    """The reference's weights, mean loss and reduced gradients, once."""
    return _reference(ARCH, "f32", mesh8)


def _jsetup(mesh8, **knobs):
    jcfg = j_configs.get_reduced(ARCH)
    jctx = JCtx.from_mesh(mesh8, remat=True, **knobs)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    return jcfg, jctx, pspecs, bspecs


def test_loss_and_gradients_match_reference(ref):
    jp, jloss, jgrads = ref
    cfg, tp = _port_params(ARCH, "f32", jp)
    assert cfg.mtp and cfg.attention == "mla" and cfg.first_k_dense == 1
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        loss, grads = per_rank_grads(tp, _port_batch(cfg, "f32", ctx), cfg,
                                     ctx, MESH)
        red, _ = reduce_gradients(grads, cfg, ctx, mesh=MESH)
    assert abs(float(loss.mean()) - jloss) <= 1e-5 * abs(jloss)
    specs = schema.partition_specs(cfg, MESH)
    assert sorted(red) == sorted(jgrads) and len(jgrads) == 46
    assert sum(n.startswith("mtp/") for n in jgrads) == 15
    assert any(n.startswith("dense_layers/") for n in jgrads)
    for n, want in jgrads.items():
        got = unstack_shards(red[n], MESH, specs[n])
        assert np.abs(want).max() > 0, n
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n


def _main_ce_ref(jp, mesh8):
    """The reference's main CE alone (its loss without the MTP term), each
    rank's mean averaged over the data ranks, on the test's batch."""
    jcfg, jctx, pspecs, bspecs = _jsetup(mesh8)
    from repro.models import transformer as j_tf

    def body(params, batch):
        h, _ = j_tf.transformer_forward(params, batch["tokens"], jcfg, jctx)
        ce = j_layers.ce_loss(h[:, :-1], params["lm_head"],
                              batch["tokens"][:, 1:], jcfg, jctx)
        return lax.pmean(ce, jctx.dp_group.axes)

    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=P())
    batch = _batch(configs.get_reduced(ARCH))
    with j_use_default(JContext(mesh=mesh8)):
        return float(jax.jit(f)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))


def test_mtp_term_matches_reference(ref, mesh8):
    """``mtp_loss`` on the port's final hidden states against the
    reference's MTP term: its whole loss less its main CE, over 0.1."""
    jp, jloss, _ = ref
    want = (jloss - _main_ce_ref(jp, mesh8)) / 0.1
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    with use_default(DiompContext(mesh=MESH, device="cpu")), \
            torch.no_grad():
        batch = _port_batch(cfg, "f32", ctx)
        h, _ = tf.transformer_forward(tp, batch["tokens"], cfg, ctx)
        term = tf.mtp_loss(tp, h, batch["tokens"], cfg, ctx)
        main = tl.ce_loss(h[..., :-1, :], tp["lm_head"],
                          batch["tokens"][..., 1:], cfg, ctx)
        whole = tf.transformer_loss(tp, batch, cfg, ctx)
    assert term.shape == MESH.sizes and bool(torch.isfinite(term).all())
    assert torch.equal(whole, main + 0.1 * term)
    # the term's share of the loss is small beside the CE's: hold it to
    # the loss's own bound, relative to the term
    got = float(term.mean())
    assert want > 1.0 and abs(got - want) <= 1e-4 * abs(want)


def _ref_drop_stats(jp, mesh8, micro):
    """The reference's ``moe_block`` stats of one step: each microbatch's
    loss traced with a frame open, summed over the world."""
    jcfg, jctx, pspecs, bspecs = _jsetup(mesh8)
    loss_fn = j_api.loss_fn(jcfg)
    axes = tuple(mesh8.axis_names)

    def body(params, batch):
        mbs = jax.tree.map(lambda x: x.reshape((micro, x.shape[0] // micro)
                                               + x.shape[1:]), batch)
        dropped = routed = jnp.zeros((), F32)
        for i in range(micro):
            mb = jax.tree.map(lambda x: x[i], mbs)
            with j_default_context().dispatch_stats.collect() as ds:
                loss_fn(params, mb, jcfg, jctx)
            dropped = dropped + j_ompccl.ensure_varying(
                ds["moe_dropped"], axes)
            routed = routed + j_ompccl.ensure_varying(ds["moe_routed"], axes)
        return lax.psum(dropped, axes), lax.psum(routed, axes)

    batch = _batch(configs.get_reduced(ARCH))
    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=(P(), P()))
    with j_use_default(JContext(mesh=mesh8)):
        d, r = jax.jit(f)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(d), float(r)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_drop_metrics_equal_reference(ref, remat, mesh8):
    jp = ref[0]
    d_ref, r_ref = _ref_drop_stats(jp, mesh8, 2)
    assert r_ref > 0
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=remat, microbatch=2)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        step = build_train_step(cfg, MESH, ctx, _sgd(1e-3), donate=False)
        _, _, m = step(tp, {}, _port_batch(cfg, "f32", ctx), 0)
    assert set(m) == {"loss", "grad_norm", "moe_dropped", "moe_drop_rate"}
    assert torch.all(m["moe_dropped"] == d_ref)
    assert torch.allclose(m["moe_drop_rate"],
                          torch.tensor(d_ref / r_ref), rtol=1e-6, atol=0)


def test_loss_logs_as_the_reference_trace(ref, mesh8):
    """The loss's forward and backward (the MTP layer's recompute included)
    log what one ``jax.eval_shape`` trace of ``value_and_grad`` of the
    reference's loss logs; a built step logs once."""
    jp = ref[0]
    jcfg, jctx, pspecs, bspecs = _jsetup(mesh8)
    loss_fn = j_api.loss_fn(jcfg)
    axes = tuple(mesh8.axis_names)

    def body(params, batch):
        p = j_ompccl.ensure_varying(params, jctx.dp_group.axes)
        loss, g = jax.value_and_grad(lambda q: loss_fn(q, batch, jcfg,
                                                       jctx))(p)
        total = sum(jnp.sum(v.astype(F32)) for v in g.values())
        return (lax.pmean(j_ompccl.ensure_varying(loss, axes), axes),
                lax.psum(j_ompccl.ensure_varying(total, axes), axes))

    batch = _batch(configs.get_reduced(ARCH))
    jdc = JContext(mesh=mesh8)
    with j_use_default(jdc):
        jax.eval_shape(shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                                 out_specs=(P(), P())),
                       jp, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    dc = DiompContext(mesh=MESH, device="cpu")
    pb = _port_batch(cfg, "f32", ctx)
    with use_default(dc):
        per_rank_grads(tp, pb, cfg, ctx, MESH)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    assert sum(sum(c.values()) for c in dc.stats().values()) > 0
    step_dc = DiompContext(mesh=MESH, device="cpu")
    with use_default(step_dc):
        step = build_train_step(cfg, MESH, ctx, _sgd(1e-3), donate=False)
        p, _, _ = step(tp, {}, pb, 0)
        once = (step_dc.stats(), step_dc.byte_stats())
        step(p, {}, pb, 1)
    assert (step_dc.stats(), step_dc.byte_stats()) == once


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"bucket_bytes": 4096,
                                    "grad_codec": "int8"}],
                         ids=["default", "4KiB", "4KiB-int8"])
def test_bucket_plan_equals_reference(knobs, mesh8):
    """The bucket plan over deepseek's tree, its ``mtp/`` and
    ``dense_layers/`` leaves included, record for record."""
    cfg = configs.get_reduced(ARCH)
    plan = bk.plan_for_config(cfg, MESH, ParallelCtx.from_mesh(MESH, **knobs))
    jplan = j_bk.plan_for_config(j_configs.get_reduced(ARCH), mesh8,
                                 JCtx.from_mesh(mesh8, **knobs))
    assert _plan_records(plan) == _plan_records(jplan)
    assert plan.total_bytes() == jplan.total_bytes()
    names = {n for b in plan.buckets for s in b.slices for n in (s.name,)}
    assert any(n.startswith("mtp/") for n in names)
    assert any(n.startswith("dense_layers/") for n in names)


@pytest.mark.parametrize("knobs", [{}, {"bucket_bytes": 4096},
                                   {"dp_backend": "flat"}],
                         ids=["default", "4KiB", "flat"])
def test_reduction_logs_match_reference(knobs, mesh8):
    """The reduction's call and byte logs over deepseek's tree against the
    reference's ``reduce_gradients`` traced once in a ``shard_map``."""
    jcfg = j_configs.get_reduced(ARCH)
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
    cfg = configs.get_reduced(ARCH)
    ctx = ParallelCtx.from_mesh(MESH, **knobs)
    specs = schema.partition_specs(cfg, MESH)
    grads = {n: stack_shards(np.zeros(s.shape, np.float32), MESH, specs[n])
             for n, s in schema.build_schema(cfg).items()}
    dc = DiompContext(mesh=MESH, device="cpu")
    with use_default(dc):
        reduce_gradients(grads, cfg, ctx, pspecs=specs, mesh=MESH)
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    assert sum(sum(c.values()) for c in dc.stats().values()) > 0


def test_launcher_trains_deepseek_on_the_cpu(monkeypatch):
    """Reduced deepseek-v3 through the launcher on the CPU: every step
    draws the pipeline's first batch, so the loss falls as the model
    memorizes it; the optimizer is picked by size, as the reference's."""
    from repro_torch.core.context import reset_default_context
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launcher

    first = SyntheticLM.batch_at
    monkeypatch.setattr(SyntheticLM, "batch_at",
                        lambda self, step: first(self, 0))
    try:
        run = launcher.main(["--arch", ARCH, "--reduced", "--steps", "8",
                             "--batch", "8", "--seq", "32", "--lr", "5e-3",
                             "--microbatch", "2", "--device", "cpu"])
        assert run["losses"][-1] < run["losses"][0] - 0.05, run["losses"]
        assert all(np.isfinite(run["grad_norms"]))
    finally:
        reset_default_context()


def test_loss_scores_a_batch_replicated_over_model():
    cfg = configs.get_reduced(ARCH)
    ctx = ParallelCtx.from_mesh(MESH)
    params = schema.init_params(cfg, MESH, torch.Generator().manual_seed(0),
                                device="cpu")
    with use_default(DiompContext(mesh=MESH, device="cpu")), \
            torch.no_grad():
        loss = api.loss_fn(cfg)(params, _port_batch(cfg, "f32", ctx), cfg,
                                ctx)
    assert loss.shape == MESH.sizes and bool(torch.isfinite(loss).all())
    assert torch.equal(loss, loss[..., :1].expand_as(loss))
