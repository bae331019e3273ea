"""The weight ring of the ZeRO-3 gather (``ring_fsdp_matmul``,
``use_ring_matmul=True``) held against the JAX package's.

* Reduced stablelm-3b on the 8-rank smoke mesh (FSDP over "data": every
  column-parallel GEMM goes round the ring) under ``ring_impl`` "fused"
  (the bidirectional schedule) and "host" (clockwise): the loss and every
  gradient leaf against ``jax.value_and_grad`` of the reference's loss
  with the same knobs in a test-built ``shard_map``, at
  ``tests/test_torch_train.py``'s tolerances (f32: loss 1e-5 relative,
  gradients 1e-4 of each leaf's largest value; bf16: 1e-3 and 2e-2).
* One column-parallel GEMM on a 4-rank data ring: the forward's puts on
  the call and byte logs equal those of the reference's
  ``ring_fsdp_matmul`` traced in ``shard_map`` (the backward logs none,
  as the transpose of the reference's ``ppermute`` does not go through
  ``ompx_put``), and its output equals the reference's within 1e-6 of its
  largest magnitude (f32 partial sums in the same schedule order).
* The ring against the all-gather path (``col_matmul`` without the ring):
  output and gradients within f32 rounding, 1e-6 of the largest
  magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.distributed import buckets as j_bk
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx

from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import layers, schema
from repro_torch.models.config import ParallelCtx
from repro_torch.train.step import per_rank_grads, reduce_gradients

from test_torch_train import (DTYPES, MESH, B, S, _batch, _np, _port_batch,
                              _port_params)

ARCH = "stablelm-3b"
IMPLS = ("fused", "host")


@functools.lru_cache(maxsize=None)
def _reference(dt, impl, mesh8):
    """The reference's mean loss and DP-reduced gradients under the ring
    (``tests/test_torch_train.py``'s ``_reference`` with the ring's knobs)."""
    jcfg = j_configs.get_reduced(ARCH)
    jdt = DTYPES[dt][0]
    jp = {k: v.astype(jdt) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    jctx = JCtx.from_mesh(mesh8, remat=True, use_ring_matmul=True,
                          ring_impl=impl)
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

    from repro_torch import configs
    batch = _batch(configs.get_reduced(ARCH))
    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=(P(), pspecs))
    with j_use_default(JContext(mesh=mesh8)):
        loss, grads = jax.jit(f)(jp, {k: jnp.asarray(v).astype(
            jdt if v.dtype == np.float32 else v.dtype)
            for k, v in batch.items()})
    return jp, float(loss), {n: _np(g) for n, g in grads.items()}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_gradients_match_reference(impl, dt, mesh8):
    jp, jloss, jgrads = _reference(dt, impl, mesh8)
    cfg, tp = _port_params(ARCH, dt, jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True, use_ring_matmul=True,
                                ring_impl=impl)
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
        assert np.abs(got - want).max() <= gtol * max(np.abs(want).max(),
                                                      1e-30), n


RING4 = RankMesh(("data", "model"), (4, 2))
X_SPEC, W_SPEC, Y_SPEC = ("data", None, None), ("data", "model"), \
    ("data", None, "model")


def _operands(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 5, 32).astype(np.float32)     # (B, T, d)
    w = rng.randn(32, 12).astype(np.float32)       # (d, out)
    return x, w


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_puts_and_output_match_reference(impl):
    """The forward's puts (calls and bytes, per group) equal the
    reference's traced ``ring_fsdp_matmul`` on a 4-rank data ring, the
    backward adds none, and the output equals the reference's within 1e-6
    of its largest magnitude."""
    jmesh = make_mesh((4, 2), ("data", "model"), axis_types="auto")
    jctx = JCtx.from_mesh(jmesh, use_ring_matmul=True, ring_impl=impl)
    x, w = _operands()
    f = shard_map(lambda x, w: j_layers.ring_fsdp_matmul(x, w, jctx),
                  mesh=jmesh, in_specs=(P(*X_SPEC), P(*W_SPEC)),
                  out_specs=P(*Y_SPEC))
    jdc = JContext(mesh=jmesh)
    with j_use_default(jdc):
        want = np.asarray(jax.jit(f)(x, w))
    ctx = ParallelCtx.from_mesh(RING4, use_ring_matmul=True, ring_impl=impl)
    dc = DiompContext(mesh=RING4, device="cpu")
    xt = stack_shards(x, RING4, X_SPEC).requires_grad_()
    wt = stack_shards(w, RING4, W_SPEC).requires_grad_()
    with use_default(dc):
        y = layers.col_matmul(xt, wt, ctx)
    logged = (dc.stats(), dc.byte_stats())
    assert logged == (jdc.stats(), jdc.byte_stats())
    assert sum(sum(v.values()) for v in logged[0].values()) > 0
    torch.autograd.grad(y.sum(), [xt, wt])
    assert (dc.stats(), dc.byte_stats()) == logged
    got = unstack_shards(y.detach(), RING4, Y_SPEC)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", [MESH, RING4], ids=["smoke8", "ring4"])
def test_ring_equals_the_allgather_path(mesh, impl):
    """``col_matmul`` through the ring against the all-gather path: the
    output and the gradients of x and of W's shards within 1e-6 of their
    largest magnitudes (f32 sums in another order)."""
    x, w = _operands(1)
    outs = []
    for ring in (True, False):
        ctx = ParallelCtx.from_mesh(mesh, use_ring_matmul=ring,
                                    ring_impl=impl)
        xt = stack_shards(x, mesh, X_SPEC if "pod" not in mesh.shape
                          else (("pod", "data"), None, None))
        wt = stack_shards(w, mesh, W_SPEC)
        xt.requires_grad_()
        wt.requires_grad_()
        with use_default(DiompContext(mesh=mesh, device="cpu")):
            y = layers.col_matmul(xt, wt, ctx)
        g = torch.autograd.grad((y * torch.linspace(-1, 1, y.shape[-1]))
                                .sum(), [xt, wt])
        outs.append((y.detach(), *g))
    for got, want in zip(*outs):
        assert torch.abs(got - want).max() <= 1e-6 * torch.abs(want).max()
