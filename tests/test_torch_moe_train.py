"""The port's MoE training slice held against the JAX package.

* ``expert_mlp_bwd_plain`` (row 12's plain version) against ``jax.vjp`` of
  the reference's ``expert_mlp_ref`` (dead rows and a zero count; dead rows
  zero in x and dy, as the dispatch layouts leave them) and against
  autograd of ``expert_mlp_plain``, in f32: within 1e-5 of each
  gradient's largest magnitude (f32 sums in another order);
* ``moe_block``'s gradient with respect to x, the router and the expert
  weights (and the shared experts') in its a2a, replicated and local
  regimes, the a2a one with and without drops, against ``jax.grad`` of the
  reference's ``moe_block`` in a ``shard_map`` on the data 1 x model 8
  mesh: within 1e-5 of each leaf's scale (f32);
* the fused and host dispatches' gradients against ``jax.grad`` of the
  oracle ``moe_ref`` at the reference test's bounds (rtol 1e-4, atol 1e-5;
  ``tests/test_moe_fused.py``); the block-level function's plain version
  and gradient, joined to the scatter and the combine as
  ``FusedDispatchFn`` joins the kernels on the card, against the
  emulation's autograd;
* reduced qwen3-moe's loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``
  (``tests/test_torch_train.py``'s f32 bounds: the loss 1e-5 relative, each
  leaf 1e-4 of its largest value).  Only f32: in bf16 one of the reduced
  model's 256 routing choices of its first layer sits 2e-5 from a tie in
  f32, and the port's bf16 forward flips it where the reference's does
  not; the flipped token moves its experts' gradients by about 30 % of
  their scale, a different routing, not an error of the gradient;
* ``moe_dropped`` and ``moe_drop_rate`` of a built step against the
  reference's ``moe_block`` stats summed over layers and microbatches,
  with remat on and off;
* a built MoE step logs once, and the loss's forward and backward log
  what one ``jax.eval_shape`` trace of ``value_and_grad`` of the
  reference's loss logs;
* the launcher trains reduced qwen3-moe on the CPU, its loss falling;
* the two new CUDA sources' entry points, ``#define``s, shared memory,
  work area and scratch planes against the wrappers' ctypes lists and the
  planner's constants and sizes; the planner's bound on the packed tiles
  against a numpy reckoning of each weight set's live rows, at small
  shapes and at both training calls.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import default_context as j_default_context
from repro.core.context import use_default as j_use_default
from repro.kernels.moe_dispatch import moe_ref as j_moe_ref
from repro.kernels.moe_dispatch import ref as j_ref
from repro.kernels.moe_dispatch import route_topk as j_route_topk
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ParallelCtx as JCtx

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels import _build, plan
from repro_torch.kernels.moe_dispatch import fused
from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
from repro_torch.kernels.moe_dispatch.kernel import (ExpertMLPFn,
                                                     expert_mlp_bwd,
                                                     expert_mlp_plain)
from repro_torch.kernels.moe_dispatch.ops import moe_dispatch
from repro_torch.kernels.moe_dispatch.ref import (expert_mlp_bwd_plain,
                                                  route_topk)
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import schema
from repro_torch.models.config import ModelConfig, ParallelCtx
from repro_torch.models.layers import moe_block
from repro_torch.train.step import (build_train_step, per_rank_grads,
                                    reduce_gradients)

from test_torch_moe_dispatch import GROUP, _dispatch_case
from test_torch_moe_model import _lspecs, _moe_cfg, _moe_lp
from test_torch_train import (B, MESH, S, _port_batch, _port_params,
                              _reference, _sgd)

ARCH = "qwen3-moe-235b-a22b"
F32 = jnp.float32


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- row 12's plain version ---------------------------------------------------------

def _mlp_case(rng, lead, E, C, d, f, counts):
    live = np.arange(C) < counts[..., None]
    x = rng.randn(*lead, E, C, d).astype(np.float32) * live[..., None]
    dy = rng.randn(*lead, E, C, d).astype(np.float32) * live[..., None]
    ws = [(rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)]
    return x, dy, ws


@pytest.mark.parametrize("shape", [(4, 8, 16, 24), (3, 5, 32, 8),
                                   (2, 17, 24, 40)])
def test_expert_mlp_bwd_plain_matches_reference_vjp(shape):
    """Dead rows (and one expert with a zero count) give zero dx and add
    nothing to dW; the live rows' gradient is the reference's einsum
    form's under ``jax.vjp``."""
    E, C, d, f = shape
    rng = np.random.RandomState(sum(shape))
    counts = np.array([C, 0, 1, C - 1][:E], np.int32)
    x, dy, ws = _mlp_case(rng, (), E, C, d, f, counts)
    _, vjp = jax.vjp(j_ref.expert_mlp_ref, x, *ws)
    want = vjp(jnp.asarray(dy))
    got = expert_mlp_bwd_plain(torch.tensor(x), *map(torch.tensor, ws),
                               torch.tensor(dy), torch.tensor(counts))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-5
    assert not got[0].numpy()[np.arange(C) >= counts[:, None]].any()


def test_expert_mlp_bwd_plain_is_autograd_in_f32():
    """Ranks x sources x experts, the weights shared by a rank's sources:
    the plain gradient equals autograd of the forward's plain version, and
    ``ExpertMLPFn`` (the CPU's plain forward and backward) gives the plain
    gradient bit for bit; the wrapper's CPU path is the plain version and
    launches nothing."""
    rng = np.random.RandomState(7)
    G, S_, E, C, d, f = 2, 3, 4, 6, 16, 8
    counts = rng.randint(0, C + 1, (G, S_, E)).astype(np.int32)
    counts[0, 0, 0] = 0
    x, dy, _ = _mlp_case(rng, (G, S_), E, C, d, f, counts)
    ws = [torch.tensor(rng.randn(G, E, a, b).astype(np.float32) / 4)
          for a, b in ((d, f), (d, f), (f, d))]
    tx, tdy, tc = torch.tensor(x), torch.tensor(dy), torch.tensor(counts)
    want = expert_mlp_bwd_plain(tx, *ws, tdy, tc)
    leaves = [t.clone().requires_grad_() for t in (tx, *ws)]
    expert_mlp_plain(*leaves, tc).backward(tdy)
    for g, w in zip(want, leaves):
        assert _rel(g.numpy(), w.grad.numpy()) <= 1e-5
    leaves = [t.clone().requires_grad_() for t in (tx, *ws)]
    before = expert_mlp_bwd.launches
    ExpertMLPFn.apply(*leaves, tc).backward(tdy)
    assert expert_mlp_bwd.launches == before
    for g, w in zip(want, leaves):
        assert torch.equal(g, w.grad)
    assert all(torch.equal(a, b) for a, b in
               zip(expert_mlp_bwd(tx, *ws, tdy, tc), want))


def test_expert_bwd_route_rule():
    """The gradient's route rule is the forward's: the tensor cores for
    aligned 16-bit operands with d and f multiples of 64."""
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        for d, f in ((4096, 1536), (256, 128), (200, 128), (256, 96),
                     (32, 64)):
            for ptr in (0, 16, 8):
                assert plan.expert_bwd_route(dt, d, f, 1024, ptr) \
                    == plan.expert_route(dt, d, f, 1024, ptr)
    assert plan.expert_bwd_route(torch.bfloat16, 4096, 1536, 0, 64) == "wgmma"
    assert plan.expert_bwd_route(torch.float32, 4096, 1536, 0) == "simt"


# -- moe_block's gradient -------------------------------------------------------------

REGIMES = {"a2a": dict(E=8, shared=0, cf=8.0, sharded=True, BT=(2, 32)),
           "a2a_shared": dict(E=8, shared=1, cf=8.0, sharded=True,
                              BT=(2, 32)),
           "a2a_tight": dict(E=8, shared=0, cf=1.0, sharded=True,
                             BT=(2, 32)),
           "replicated": dict(E=8, shared=0, cf=8.0, sharded=True,
                              BT=(1, 4)),
           "local": dict(E=6, shared=0, cf=8.0, sharded=False, BT=(2, 32))}


def _replicated(spec):
    return all(a is None for a in spec)


def _ref_block_grads(cfg, lp, x, cot, sharded, **knobs):
    """The reference's ``moe_block`` under ``jax.grad`` on data 1 x model
    8: every rank's x and weights made varying, so each rank gets its own
    gradient; replicated leaves then sum their ranks' gradients."""
    mesh = make_mesh((1, 8), ("data", "model"), axis_types="auto")
    ctx = JCtx.from_mesh(mesh, **knobs)
    specs = _lspecs(lp, sharded)
    jspecs = {k: P(*v) for k, v in specs.items()}

    def f(xx, pp, cc):
        xx = j_ompccl.ensure_varying(xx, ("model",))
        pp = j_ompccl.ensure_varying(pp, ("model",))

        def loss(a, b):
            out = j_layers.moe_block(a, b, cfg, ctx)
            return jnp.sum(out.astype(F32) * cc)

        gx, gp = jax.grad(loss, argnums=(0, 1))(xx, pp)
        gp = {k: lax.psum(v, "model") if _replicated(specs[k]) else v
              for k, v in gp.items()}
        return lax.psum(gx, "model"), gp

    with j_use_default(JContext()):
        gx, gp = jax.jit(shard_map(f, mesh=mesh,
                                   in_specs=(P(), jspecs, P()),
                                   out_specs=(P(), jspecs)))(x, lp, cot)
    return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _port_block_grads(cfg, lp, x, cot, sharded, invariant, **knobs):
    """The port's ``moe_block`` under autograd, each rank's loss seeded as
    the reference's AD seeds it: an output the reference types invariant
    over "model" (the replicated regime's psum) counts once, a varying one
    (the a2a regime's all-gather) once a rank."""
    mesh = RankMesh(("data", "model"), (1, 8))
    ctx = ParallelCtx.from_mesh(mesh, **knobs)
    specs = _lspecs(lp, sharded)
    tlp = {k: stack_shards(v, mesh, specs[k]).requires_grad_()
           for k, v in lp.items()}
    tx = stack_shards(x, mesh, (None,) * 3).requires_grad_()
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        out = moe_block(tx, tlp, cfg, ctx)
    (out * torch.tensor(cot) / (8 if invariant else 1)).sum().backward()
    gp = {}
    for k, t in tlp.items():
        g = t.grad
        if _replicated(specs[k]):     # every rank's copy, summed
            g = g.sum(dim=(0, 1), keepdim=True).expand_as(g)
        gp[k] = unstack_shards(g, mesh, specs[k])
    return tx.grad.sum(dim=(0, 1)).numpy(), gp


@pytest.mark.parametrize("case", sorted(REGIMES))
def test_moe_block_gradients_match_reference(case):
    r = REGIMES[case]
    jcfg, cfg = (_moe_cfg(c, r["E"], r["shared"], r["cf"])
                 for c in (JModelConfig, ModelConfig))
    lp = _moe_lp(jcfg, seed=3)
    rng = np.random.RandomState(11)
    x = rng.randn(*r["BT"], 32).astype(np.float32)
    cot = rng.randn(*r["BT"], 32).astype(np.float32)
    wx, wp = _ref_block_grads(jcfg, lp, x, cot, r["sharded"])
    gx, gp = _port_block_grads(cfg, lp, x, cot, r["sharded"],
                               case == "replicated")
    assert _rel(gx, wx) <= 1e-5
    assert sorted(gp) == sorted(wp)
    for k in wp:
        assert _rel(gp[k], wp[k]) <= 1e-5, k
        assert np.abs(wp[k]).max() > 0, k


# -- the dropless dispatch's gradient ---------------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "host"])
def test_dropless_gradients_match_the_oracle(impl):
    """The reference's ``test_fused_gradients_match_oracle`` on the port:
    each rank's loss sum(y^2) through the routing and the dispatch, the
    gradients of the tokens and the expert weights against ``jax.grad`` of
    the oracle ``moe_ref`` over the global loss."""
    ndev = 4
    c = _dispatch_case(ndev, E=8, t_loc=8, d=12, f=16)
    mesh = RankMesh(("x",), (ndev,))
    router = torch.tensor(c["router"])
    toks = stack_shards(c["toks"], mesh, ("x", None)).requires_grad_()
    ws = [stack_shards(w, mesh, ("x", None, None)).requires_grad_()
          for w in c["ws"]]
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        w, e = route_topk(toks, router, 2)
        y = moe_dispatch(toks, e, w, *ws, GROUP, impl=impl, plan=c["tplan"])
    (y.float() ** 2).sum().backward()

    def ref_loss(tk, wgt):
        wt, et = j_route_topk(tk, jnp.asarray(c["router"]), 2)
        return (j_moe_ref(tk, et, wt, *wgt).astype(F32) ** 2).sum()

    rt, rw = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jnp.asarray(c["toks"]), tuple(map(jnp.asarray, c["ws"])))
    np.testing.assert_allclose(unstack_shards(toks.grad, mesh, ("x", None)),
                               np.asarray(rt), rtol=1e-4, atol=1e-5)
    for got, ref in zip(ws, rw):
        np.testing.assert_allclose(
            unstack_shards(got.grad, mesh, ("x", None, None)),
            np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ndev,overlap", [(2, True), (4, True), (4, False)])
def test_block_level_gradient_equals_the_emulation(ndev, overlap):
    """The card's path on CPU tensors: the routing scatter and the combine
    under autograd around the block-level function's plain version, its
    cotangent taken through the backward's wrapper (its plain version
    here) and the blocks' gradient fed back through the scatter, as
    ``FusedDispatchFn`` (card only) joins the kernels; against the
    emulation under autograd: the tokens', gates' and experts' gradients
    within 1e-5 of their scale (f32 sums in another order);
    ``fused_dispatch_bwd_plain`` against autograd of
    ``fused_dispatch_blocks_plain`` alone, and nothing launched."""
    c = _dispatch_case(ndev, E=8, t_loc=8, d=16, f=24)
    mesh = RankMesh(("x",), (ndev,))
    p = c["tplan"] if overlap else \
        plan.OverlapPlanner().plan_alltoall(8, 16, 2, 8, ndev, torch.float32,
                                            overlap=False)
    cot = torch.tensor(np.random.RandomState(ndev).randn(ndev, 8, 16)
                       .astype(np.float32))
    grads = []
    for mode in ("blocks", "emulation"):
        leaves = [stack_shards(c["toks"], mesh, ("x", None)),
                  stack_shards(c["tw"].numpy(), mesh, ("x", None))]
        leaves += [stack_shards(w, mesh, ("x", None, None)) for w in c["ws"]]
        leaves = [t.requires_grad_() for t in leaves]
        toks, tw, wg, wu, wd = leaves
        te = stack_shards(c["te"].numpy(), mesh, ("x", None))
        with use_default(DiompContext(mesh=mesh, device="cpu")):
            if mode == "blocks":
                buf, addr, gates, _, counts = fused.dispatch_buffers(
                    toks, te, tw, p)
                ws = [w.detach() for w in (wg, wu, wd)]
                full = fused.fused_dispatch_blocks_plain(
                    buf.detach(), *ws, counts, GROUP).requires_grad_()
                out = fused._combine(full, addr, gates, 8, 16)
            else:
                out, _ = fused.fused_moe_dispatch_interpret(
                    toks, te, tw, wg, wu, wd, GROUP, plan=p,
                    mlp=expert_mlp_plain)
            (out * cot).sum().backward()
            if mode == "blocks":
                before = fused.fused_dispatch_bwd_kernel.launches
                dbuf, *dws = fused.fused_dispatch_bwd_kernel(
                    buf.detach(), *ws, counts, full.grad, GROUP, plan=p)
                assert fused.fused_dispatch_bwd_kernel.launches == before
                buf.backward(dbuf)
                for w, dw in zip((wg, wu, wd), dws):
                    w.grad = dw
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel(got.numpy(), want.numpy()) <= 1e-5
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        toks = stack_shards(c["toks"], mesh, ("x", None))
        te = stack_shards(c["te"].numpy(), mesh, ("x", None))
        tw = stack_shards(c["tw"].numpy(), mesh, ("x", None))
        buf, _, _, _, counts = fused.dispatch_buffers(toks, te, tw, p)
        leaves = [t.clone().requires_grad_() for t in
                  [buf] + [stack_shards(w, mesh, ("x", None, None))
                           for w in c["ws"]]]
        dfull = torch.randn(buf.shape, generator=torch.Generator()
                            .manual_seed(1))
        fused.fused_dispatch_blocks_plain(*leaves, counts,
                                          GROUP).backward(dfull)
        before = fused.fused_dispatch_bwd_kernel.launches
        got = fused.fused_dispatch_bwd_kernel(*(t.detach() for t in leaves),
                                              counts, dfull, GROUP, plan=p)
        assert fused.fused_dispatch_bwd_kernel.launches == before
    live = (torch.arange(p.cap_pad) < counts[..., None])[..., None]
    assert not got[0][~live.expand_as(got[0])].any()
    for g, leaf in zip(got, leaves):
        want = leaf.grad * live if g.shape == buf.shape else leaf.grad
        assert _rel(g.numpy(), want.numpy()) <= 1e-5


# -- the reduced model's loss, its step and its logs ----------------------------------

def test_moe_loss_and_gradients_match_reference(mesh8):
    jp, jloss, jgrads = _reference(ARCH, "f32", mesh8)
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        loss, grads = per_rank_grads(tp, _port_batch(cfg, "f32", ctx), cfg,
                                     ctx, MESH)
        red, _ = reduce_gradients(grads, cfg, ctx, mesh=MESH)
    assert abs(float(loss.mean()) - jloss) <= 1e-5 * abs(jloss)
    specs = schema.partition_specs(cfg, MESH)
    assert sorted(red) == sorted(jgrads)
    for n, want in jgrads.items():
        got = unstack_shards(red[n], MESH, specs[n])
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), n
        assert np.abs(want).max() > 0, n


def _ref_drop_stats(mesh8, micro):
    """The reference's ``moe_block`` stats of one step: each microbatch's
    loss traced with a frame open (as its step's ``local_loss``), the
    per-rank sums over layers added over the microbatches and summed over
    the world."""
    jcfg = j_configs.get_reduced(ARCH)
    jp = {k: v.astype(F32) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    jctx = JCtx.from_mesh(mesh8, remat=True)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    loss_fn = j_api.loss_fn(jcfg)
    axes = tuple(mesh8.axis_names)

    def body(params, batch):
        k = micro
        mbs = jax.tree.map(lambda x: x.reshape((k, x.shape[0] // k)
                                               + x.shape[1:]), batch)
        dropped = routed = jnp.zeros((), F32)
        for i in range(k):
            mb = jax.tree.map(lambda x: x[i], mbs)
            with j_default_context().dispatch_stats.collect() as ds:
                loss_fn(params, mb, jcfg, jctx)
            dropped = dropped + j_ompccl.ensure_varying(
                ds["moe_dropped"], axes)
            routed = routed + j_ompccl.ensure_varying(ds["moe_routed"], axes)
        return lax.psum(dropped, axes), lax.psum(routed, axes)

    from test_torch_train import _batch
    batch = _batch(configs.get_reduced(ARCH))
    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=(P(), P()))
    with j_use_default(JContext(mesh=mesh8)):
        d, r = jax.jit(f)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(d), float(r)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_drop_metrics_equal_reference(remat, mesh8):
    """A checkpointed layer's recompute runs ``moe_block`` again in the
    backward; the step's frame has closed by then, so the drops count once
    and the metrics are the same with remat on and off."""
    d_ref, r_ref = _ref_drop_stats(mesh8, 2)
    assert d_ref > 0 and r_ref > 0
    jp, _, _ = _reference(ARCH, "f32", mesh8)
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=remat, microbatch=2)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        step = build_train_step(cfg, MESH, ctx, _sgd(1e-3), donate=False)
        _, _, m = step(tp, {}, _port_batch(cfg, "f32", ctx), 0)
    assert set(m) == {"loss", "grad_norm", "moe_dropped", "moe_drop_rate"}
    assert torch.all(m["moe_dropped"] == d_ref)
    assert torch.allclose(m["moe_drop_rate"],
                          torch.tensor(d_ref / r_ref), rtol=1e-6, atol=0)


def test_dense_step_has_no_drop_metrics(mesh8):
    jp, _, _ = _reference("stablelm-3b", "f32", mesh8)
    cfg, tp = _port_params("stablelm-3b", "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        step = build_train_step(cfg, MESH, ctx, _sgd(1e-3), donate=False)
        _, _, m = step(tp, {}, _port_batch(cfg, "f32", ctx), 0)
    assert set(m) == {"loss", "grad_norm"}


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_moe_loss_logs_as_the_reference_trace(impl, mesh8):
    """The loss's forward and backward (each layer's recompute included)
    log what one ``jax.eval_shape`` trace of ``value_and_grad`` of the
    reference's loss logs: the backward transposes puts and collectives
    without logging them, in both packages; a built step logs once."""
    jcfg = j_configs.get_reduced(ARCH)
    jctx = JCtx.from_mesh(mesh8, remat=True, dispatch_impl=impl)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    loss_fn = j_api.loss_fn(jcfg)
    jp, _, _ = _reference(ARCH, "f32", mesh8)

    axes = tuple(mesh8.axis_names)

    def body(params, batch):
        p = j_ompccl.ensure_varying(params, jctx.dp_group.axes)
        loss, g = jax.value_and_grad(lambda q: loss_fn(q, batch, jcfg,
                                                       jctx))(p)
        total = sum(jnp.sum(v.astype(F32)) for v in g.values())
        # lax collectives: the OMPCCL logs see only the loss's own
        return (lax.pmean(j_ompccl.ensure_varying(loss, axes), axes),
                lax.psum(j_ompccl.ensure_varying(total, axes), axes))

    from test_torch_train import _batch
    batch = _batch(configs.get_reduced(ARCH))
    jdc = JContext(mesh=mesh8)
    with j_use_default(jdc):
        jax.eval_shape(shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                                 out_specs=(P(), P())),
                       jp, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, tp = _port_params(ARCH, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True, dispatch_impl=impl)
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


def test_launcher_trains_moe_on_the_cpu(monkeypatch):
    """Reduced qwen3-moe through the launcher on the CPU: the synthetic
    tokens are uniform, so every step draws the pipeline's first batch and
    the loss falls as the model memorizes it."""
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


# -- the CUDA sources against the wrappers -------------------------------------------

def _entry_kinds(text, fn):
    params = re.search(r'extern "C" int %s\(([^)]*)\)' % fn, text).group(1)
    kinds = []
    for par in params.split(","):
        par = " ".join(par.split())
        kinds.append(_build._P if "*" in par else
                     _build._LL if par.startswith("long long") else
                     _build._I if par.startswith("int") else None)
    return kinds, [p.split()[-1] for p in params.split(",")]


@pytest.mark.parametrize("lib", ["expert_mlp_bwd", "moe_dispatch_bwd"])
def test_gradient_sources_match_the_wrappers(lib):
    """Each new entry point's ctypes list against its C signature, its
    route code second to last; both include ``expert_bwd.cuh``, whose
    ``#define``s and shared-memory expression are the planner's."""
    source, fns = _build.LIBRARIES[lib]
    assert source == f"{lib}.cu"
    text = (_build.CSRC / source).read_text()
    assert '#include "expert_bwd.cuh"' in text
    (fn, argtypes), = fns.items()
    kinds, names = _entry_kinds(text, fn)
    assert kinds == argtypes
    assert names[-2:] == ["route", "stream"]
    wrapper = (mlp_mod.expert_mlp_bwd if lib == "expert_mlp_bwd"
               else fused.fused_dispatch_bwd_kernel)
    assert set(wrapper.route_launches) == set(_build.ROUTE_CODES)


def test_gradient_header_matches_the_planner():
    """``expert_bwd.cuh``'s ``#define``s, shared memory, work area and
    scratch planes against the planner's constants and sizes."""
    text = (_build.CSRC / "expert_bwd.cuh").read_text()
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    assert d["EXB_BR"] == plan.EXB_BR == 64
    for name in ("EXB_STAGES", "EXB_BOXES", "EXB_SLOTS", "EXB_OUT_TILES",
                 "EXB_THREADS"):
        assert d[name] == getattr(plan, name), name
    assert plan.EXB_THREADS == 2 * 128 + 32     # two warpgroups, a producer
    consts = {k: d[k] for k in ("EXB_STAGES", "EXB_BOXES", "EXB_SLOTS",
                                "EXB_OUT_TILES", "EXB_BR")}
    expr = re.search(r"exb_smem_bytes\(\) \{\s*return ([^;]+);",
                     text).group(1)
    # pass C's stages of dg, du and h, its slots of x and dy (two
    # warpgroups' boxes each) and output tiles; passes A and B lay their
    # stages in the same bytes
    c_boxes = int(re.search(r"EXB_C_BOXES = (\d+);", text).group(1))
    assert c_boxes == 3
    smem = eval(" ".join(expr.split()), {**consts, "EXB_C_BOXES": c_boxes,
                                         "EXB_BOX_BYTES": 64 * 64 * 2})
    assert smem == plan.expert_bwd_smem_bytes() <= plan.SMEM_BUDGET_DEFAULT
    ring = plan.EXB_STAGES * c_boxes + 4 * plan.EXB_SLOTS \
        + plan.EXB_OUT_TILES
    assert plan.EXB_STAGES * plan.EXB_BOXES <= ring
    meta = re.search(r"exb_meta_words\([^)]*\) \{\s*return ([^;]+);",
                     text).group(1)
    work = re.search(r"exb_work_words\([^)]*\) \{\s*const long long m = "
                     r"[^;]+;\s*return ([^;]+);", text).group(1)
    planes = re.search(r"return ExbPlanes<T>\{([^}]*)\};", text).group(1)
    for NW, NS, PT, dd, ff in ((1, 1, 1, 64, 64), (256, 2, 768, 4096, 1536),
                               (256, 2, 508, 4096, 1536), (9, 3, 17, 192, 320)):
        env = {"NW": NW, "NS": NS, "PT": PT, **consts}
        m = eval(meta, env)
        words = eval(work.replace("LL", ""), {**env, "m": m})
        assert words == plan.expert_bwd_work_words(NW, NS, PT)
        starts = [eval(x.strip().replace("p + ", "").replace("p", "0"),
                       {"R": PT * 64, "d": dd, "f": ff})
                  for x in " ".join(planes.split()).split(",")]
        assert starts[-1] + PT * 64 * ff \
            == plan.expert_bwd_scratch_elems(PT, dd, ff)


def _routed_counts(rng, ranks, ep, E_loc, t_loc, k):
    """``(ranks, ep, E_loc)`` kept rows a dropless dispatch sends: each
    rank's ``t_loc`` tokens choose ``k`` distinct experts of ``ep E_loc``,
    the experts' popularity skewed."""
    E = ep * E_loc
    pop = rng.gamma(0.5, size=E)
    counts = np.zeros((ranks, E), np.int64)
    for r in range(ranks):
        for _ in range(t_loc):
            counts[r, rng.choice(E, k, replace=False, p=pop / pop.sum())] += 1
    return counts.reshape(ranks, ep, E_loc)


# (G, S, E, C) of the grouped call, or the ring's (ranks, ep, E_loc, C,
# t_loc, k); the training calls are qwen3-moe's a2a call (4 ranks, 2
# sources, 64 experts of 80 rows; about 13,406 live rows, and every row
# live) and its fused plan (2 rings of 2, 64 local experts, the worst-case
# plan's 512 rows, 512 tokens a rank, top-8)
PACK_CASES = {
    "a2a call": ("grouped", (4, 2, 64, 80), 0.33),
    "a2a every row": ("grouped", (4, 2, 64, 80), 1.0),
    "small checks": ("grouped", (2, 2, 4, 80), 0.6),
    "off the tile": ("grouped", (1, 2, 3, 130), 0.8),
    "fused plan": ("ring", (4, 2, 64, 512, 512, 8), None),
    "fused ring of 4": ("ring", (4, 4, 4, 48, 24, 2), None),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_packed_tiles_hold_every_live_row(case):
    """The planner's packed-tile bound against a numpy reckoning of what
    ``exb_build_pack`` fills: each weight set's live rows over its sources
    in ``ceil(rows / 64)`` tiles, every tile within the bound (the kernel
    traps past it), and the work area and scratch of that many tiles.  At
    the training calls: the a2a call packs into at most 768 tiles (1.26 GB
    of scratch, against the padded layout's 0.38 GB of dg, du and h) and the
    fused plan's transients are under 1 GB, against about 5.6 GB of padded
    scratch and landing slots."""
    kind, shape, fill = PACK_CASES[case]
    rng = np.random.RandomState(len(case))
    d, f = 4096, 1536
    if kind == "grouped":
        G, S_, E, C = shape
        counts = (rng.rand(G, S_, E) * fill * 2 * C).astype(int).clip(0, C)
        if fill == 1.0:
            counts[:] = C
        live = counts.transpose(0, 2, 1).reshape(G * E, S_)  # (set, source)
        sets, sources, rows = G * E, S_, None
        bound = plan.expert_bwd_tiles(sets, sources, C)
    else:
        ranks, ep, E_loc, C, t_loc, k = shape
        counts = _routed_counts(rng, ranks, ep, E_loc, t_loc, k)
        assert counts.max() <= C and (counts.sum((1, 2)) == t_loc * k).all()
        G = ranks // ep
        # (g, src, dst, e) -> set (g, dst, e), source offset s = dst - src
        c = counts.reshape(G, ep, ep, E_loc)
        live = np.zeros((G, ep, E_loc, ep), np.int64)
        for src in range(ep):
            for dst in range(ep):
                live[:, dst, :, (dst - src) % ep] = c[:, src, dst]
        live = live.reshape(G * ep * E_loc, ep)
        sets, sources, rows = G * ep * E_loc, ep, ranks * t_loc * k
        bound = plan.expert_bwd_tiles(sets, sources, C, rows=rows)
        # the worst the plan allows: every set one row past a tile
        worst = -(-(rows + 63 * sets) // 64)
        assert bound == min(sets * -(-ep * C // 64), worst)
    per_set = live.sum(1)
    need = int(np.ceil(per_set / 64).sum())
    assert need <= bound
    assert plan.expert_bwd_tiles(sets, sources, C) >= bound
    words = 1 + bound + sets * (sources + 2)
    assert plan.expert_bwd_work_words(sets, sources, bound) \
        == words + words % 2 + 2 * 64 * bound
    scratch = 2 * plan.expert_bwd_scratch_elems(bound, d, f)   # bf16 bytes
    assert scratch == 2 * bound * 64 * (2 * d + 3 * f)
    if case == "a2a call":
        assert bound == 768 and scratch == 1_258_291_200
        assert 12_000 <= per_set.sum() <= 15_000
    if case == "fused plan":
        assert bound == 508 and int(per_set.sum()) == 16_384
        transient = scratch + 4 * plan.expert_bwd_work_words(sets, ep, bound)
        padded = 2 * 3 * G * ep * E_loc * C * (ep * f + (ep - 1) * d)
        assert transient < 1e9 and 5.5e9 < padded < 5.7e9
