"""The port's hierarchical OMPCCL backend and cost model held against the
JAX package.

Same seeded numpy inputs through the reference's ``shard_map`` collectives
and the port's stacked-rank verbs.  Sums are compared at 1e-6 relative in
f32 (the frameworks may add in another order); max/min and pure moves
exactly; the bf16 pad path at 1e-2 (one bf16 ulp is 2^-8 of the value and
each of the three phases rounds once).  Call and byte logs, the backend
registry, ``inter_pod_traffic_bytes`` and every cost function are compared
exactly (the cost functions to 1e-12 relative, given the same link
parameters).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import backends as j_backends
from repro.core import rma as j_rma
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.distributed import hierarchical as j_hier

from repro_torch.core import backends, ompccl, rma
from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.distributed import hierarchical
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.launch.mesh import RankMesh

AXES8 = ("pod", "data", "model")
T_MESH8 = RankMesh(AXES8, (2, 2, 2))
SPEC8 = (AXES8, None)
GROUPS = [("pod", "data"), AXES8, ("data", "model"), ("model",)]


def _jax(mesh, fn, x, n_out=1, spec=P(AXES8)):
    out = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec,
                            out_specs=spec if n_out == 1
                            else (spec,) * n_out))(x)
    return [np.asarray(o) for o in out] if n_out > 1 else np.asarray(out)


def _unstack(t):
    return unstack_shards(t, T_MESH8, (AXES8,) + (None,) * (t.dim() - 4))


def _contexts(mesh8):
    return (JContext(mesh=mesh8, segment_bytes=1 << 20),
            DiompContext(mesh=T_MESH8, device="cpu"))


@pytest.mark.parametrize("axes", GROUPS)
@pytest.mark.parametrize("cols", [16, 5])
def test_hierarchical_allreduce_matches_jax(mesh8, axes, cols):
    """f32, with a payload the fast domain divides (16) and one it does
    not (5: the pad path); call and byte logs equal."""
    x = np.random.RandomState(3).randn(8 * 2, cols).astype(np.float32)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(JGroup(axes), backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.allreduce(v), x)
    c = ctx.communicator(DiompGroup(axes), backend="hierarchical")
    got = c.allreduce(stack_shards(x, T_MESH8, SPEC8))
    np.testing.assert_allclose(_unstack(got), want, rtol=1e-6, atol=1e-6)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()
    flat = ctx.communicator(DiompGroup(axes)).allreduce(
        stack_shards(x, T_MESH8, SPEC8))
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_hierarchical_pad_path_bf16_matches_jax(mesh8):
    """5 elements a rank over a fast domain of 2: the pad round trip, in
    bf16, against the reference's and against the exact f32 sum (the
    reference's own 0.05)."""
    x = np.random.RandomState(6).randn(4, 10).astype(np.float32)
    spec = P(("pod", "data"), "model")
    dp_j, dp_t = JGroup(("pod", "data"), "dp"), DiompGroup(("pod", "data"),
                                                           "dp")
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(dp_j, backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.allreduce(v.astype(jnp.bfloat16))
                .astype(jnp.float32), x, spec=spec)
    t_spec = (("pod", "data"), "model")
    xs = stack_shards(x, T_MESH8, t_spec, dtype=torch.bfloat16)
    got = ctx.communicator(dp_t, backend="hierarchical").allreduce(xs)
    assert got.dtype == torch.bfloat16
    got = unstack_shards(got, T_MESH8, t_spec)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got, np.tile(xb.sum(0), (4, 1)), rtol=0.05,
                               atol=0.05)
    assert ctx.byte_stats() == jctx.byte_stats()


@pytest.mark.parametrize("op", ["max", "min"])
def test_hierarchical_max_min_take_the_flat_path(mesh8, op):
    x = np.random.RandomState(7).randn(8 * 2, 10).astype(np.float32)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(JGroup(("pod", "data")), backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.allreduce(v, op=op), x)
    xs = stack_shards(x, T_MESH8, SPEC8)
    c = ctx.communicator(DiompGroup(("pod", "data")), backend="hierarchical")
    got = c.allreduce(xs, op=op)
    np.testing.assert_array_equal(_unstack(got), want)
    flat = hierarchical.flat_allreduce(xs, DiompGroup(("pod", "data")),
                                       T_MESH8, op=op)
    assert torch.equal(got, flat)
    with pytest.raises(ValueError):
        hierarchical.flat_allreduce(xs, DiompGroup(("pod", "data")),
                                    T_MESH8, op="mean")


@pytest.mark.parametrize("axes", [("pod", "data"), AXES8])
def test_rs_then_invariant_ag_round_trip(mesh8, axes):
    """The hierarchical RS (fast axes first) and invariant AG invert each
    other through one handle: RS -> AG == the flat sum."""
    x = np.random.RandomState(9).randn(8 * 2, 24).astype(np.float32)
    g_j, g_t = JGroup(axes), DiompGroup(axes)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(g_j, backend="hierarchical")

    def j_fn(v):
        sh = jc.reducescatter(v.reshape(-1))
        return jc.allgather(sh, invariant=True).reshape(v.shape), sh

    want, want_sh = _jax(mesh8, j_fn, x, n_out=2)
    c = ctx.communicator(g_t, backend="hierarchical")
    xs = stack_shards(x, T_MESH8, SPEC8)
    sh = c.reducescatter(xs.reshape(2, 2, 2, -1))
    got = c.allgather(sh, invariant=True).reshape(xs.shape)
    np.testing.assert_allclose(_unstack(sh), want_sh, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_unstack(got), want, rtol=1e-6, atol=1e-6)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()
    flat = ctx.communicator(g_t).allreduce(xs)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_rs_then_row_major_ag_permutes(mesh8):
    """RS paired with the non-invariant (row-major) all-gather returns the
    reference's element permutation of the flat sum, not the flat sum."""
    axes = ("pod", "data")
    x = np.random.RandomState(10).randn(8 * 2, 8).astype(np.float32)
    g_j, g_t = JGroup(axes), DiompGroup(axes)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(g_j, backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.allgather(
        jc.reducescatter(v.reshape(-1))).reshape(v.shape), x)
    c = ctx.communicator(g_t, backend="hierarchical")
    xs = stack_shards(x, T_MESH8, SPEC8)
    got = c.allgather(c.reducescatter(xs.reshape(2, 2, 2, -1))).reshape(
        xs.shape)
    np.testing.assert_allclose(_unstack(got), want, rtol=1e-6, atol=1e-6)
    assert ctx.stats() == jctx.stats()
    flat = ctx.communicator(g_t).allreduce(xs)
    assert not np.allclose(got.numpy(), flat.numpy())
    np.testing.assert_allclose(np.sort(got.numpy(), axis=None),
                               np.sort(flat.numpy(), axis=None), rtol=1e-6)


@pytest.mark.parametrize("axes", [("pod", "data"), AXES8, ("model",)])
@pytest.mark.parametrize("axis,tiled", [(0, True), (1, True), (0, False)])
def test_hierarchical_allgather_matches_jax(mesh8, axes, axis, tiled):
    """Row-major concatenation order (fast axes first, slow last), and the
    untiled gather through the flat path."""
    x = np.random.RandomState(11).randn(8 * 3, 4).astype(np.float32)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(JGroup(axes), backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.allgather(v, axis=axis, tiled=tiled), x)
    c = ctx.communicator(DiompGroup(axes), backend="hierarchical")
    got = c.allgather(stack_shards(x, T_MESH8, SPEC8), axis=axis,
                      tiled=tiled)
    np.testing.assert_array_equal(_unstack(got), want)
    assert ctx.byte_stats() == jctx.byte_stats()


def test_bcast_through_hierarchical_matches_jax(mesh8):
    x = np.random.RandomState(12).randn(8 * 2, 6).astype(np.float32)
    jctx, ctx = _contexts(mesh8)
    jc = jctx.communicator(JGroup(AXES8), backend="hierarchical")
    want = _jax(mesh8, lambda v: jc.bcast(v, root=5), x)
    c = ctx.communicator(DiompGroup(AXES8), backend="hierarchical")
    got = c.bcast(stack_shards(x, T_MESH8, SPEC8), root=5)
    np.testing.assert_allclose(_unstack(got), want, rtol=1e-6, atol=1e-6)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()


@pytest.mark.parametrize("halo,per", [(1, 3), (2, 2), (3, 5)])
def test_halo_exchange_hierarchical_equals_xla(halo, per):
    """The halo pattern through a hierarchical handle equals the flat
    one's and the reference's, with the same logs (as
    tests/test_halo_props.py holds the reference)."""
    ndev = 4
    mesh = make_mesh((ndev,), ("x",), axis_types="auto")
    t_mesh = RankMesh(("x",), (ndev,))
    x = np.arange(ndev * per * 3, dtype=np.float32).reshape(ndev * per, 3)
    g_j, g_t = JGroup(("x",), "halo-ring"), DiompGroup(("x",), "halo-ring")
    jctx = JContext(mesh=mesh, segment_bytes=1 << 20)
    with j_use_default(jctx):
        want = _jax(mesh, lambda v: j_rma.halo_exchange(
            v, g_j, halo=halo, axis=0, backend="hierarchical"), x, n_out=2,
            spec=P("x"))
    outs = {}
    for backend in ("xla", "hierarchical"):
        ctx = DiompContext(mesh=t_mesh, device="cpu")
        with use_default(ctx):
            outs[backend] = rma.halo_exchange(
                stack_shards(x, t_mesh, ("x", None)), g_t, halo=halo,
                axis=0, backend=backend)
        assert ctx.stats() == jctx.stats()
        assert ctx.byte_stats() == jctx.byte_stats()
    for h, f, w in zip(outs["hierarchical"], outs["xla"], want):
        assert torch.equal(h, f)
        np.testing.assert_array_equal(unstack_shards(h, t_mesh, ("x", None)),
                                      w)


def test_free_function_hierarchical_logs_match_jax(mesh8):
    """``ompccl.*(backend="hierarchical")`` records the reference's calls
    and per-rank bytes, reduce and bcast included."""
    x = np.random.RandomState(13).randn(8 * 2, 8).astype(np.float32)
    g_j, g_t = JGroup(("pod", "data"), "dp"), DiompGroup(("pod", "data"),
                                                         "dp")
    jctx, ctx = _contexts(mesh8)
    from repro.core import ompccl as j_ompccl

    def j_ops(v):
        kw = {"backend": "hierarchical"}
        a = j_ompccl.allreduce(v, g_j, **kw)
        r = j_ompccl.reduce(v, g_j, root=1, **kw)
        b = j_ompccl.bcast(v, g_j, root=2, **kw)
        rs = j_ompccl.reducescatter(v.reshape(-1), g_j, **kw)
        ag = j_ompccl.allgather(rs, g_j, invariant=True, **kw)
        return a + r + b + ag.reshape(v.shape)

    with j_use_default(jctx):
        want = _jax(mesh8, j_ops, x)
    xs = stack_shards(x, T_MESH8, SPEC8)
    with use_default(ctx):
        kw = {"backend": "hierarchical"}
        a = ompccl.allreduce(xs, g_t, **kw)
        r = ompccl.reduce(xs, g_t, root=1, **kw)
        b = ompccl.bcast(xs, g_t, root=2, **kw)
        rs = ompccl.reducescatter(xs.reshape(2, 2, 2, -1), g_t, **kw)
        ag = ompccl.allgather(rs, g_t, invariant=True, **kw)
        got = a + r + b + ag.reshape(xs.shape)
    np.testing.assert_allclose(_unstack(got), want, rtol=1e-5, atol=1e-5)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()


@pytest.mark.parametrize("payload,fast,slow", [
    (1 << 20, 2, 2), (12345, 4, 2), (1 << 30, 16, 2), (7, 3, 1), (999, 1, 5)])
@pytest.mark.parametrize("hier", [True, False])
def test_inter_pod_traffic_bytes_equal(payload, fast, slow, hier):
    assert hierarchical.inter_pod_traffic_bytes(
        payload, fast, slow, hierarchical=hier) == \
        j_hier.inter_pod_traffic_bytes(payload, fast, slow,
                                       hierarchical=hier)


LINKS = [(450e9, 0.0, 0.0), (50e9, 1e-6, 5e-6), (25e9, 5e-6, 2e-5)]


def _links(params):
    bw, lat, disp = params
    return (backends.LinkModel(bandwidth_Bps=bw, latency_s=lat,
                               dispatch_s=disp),
            j_backends.LinkModel(bandwidth_Bps=bw, latency_s=lat,
                                 dispatch_s=disp))


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0.0), (a, b)


@pytest.mark.parametrize("params", LINKS)
@pytest.mark.parametrize("nbytes,ndev", [(0, 4), (4096, 1), (4096, 2),
                                         (1 << 24, 8), (1 << 30, 16)])
def test_ring_cost_functions_equal(params, nbytes, ndev):
    t, j = _links(params)
    _close(backends.ring_allreduce_time(nbytes, ndev, t),
           j_backends.ring_allreduce_time(nbytes, ndev, j))
    _close(backends.ring_allgather_time(nbytes, ndev, t),
           j_backends.ring_allgather_time(nbytes, ndev, j))
    _close(t.collective_time(nbytes, ndev), j.collective_time(nbytes, ndev))


@pytest.mark.parametrize("intra_p,inter_p", [(LINKS[0], LINKS[1]),
                                             (LINKS[1], LINKS[2]),
                                             (LINKS[2], LINKS[0])])
@pytest.mark.parametrize("nbytes,intra,inter", [
    (1 << 24, 4, 2), (12345, 3, 5), (1 << 30, 16, 2), (100, 1, 1)])
def test_hierarchical_allreduce_time_equal(intra_p, inter_p, nbytes, intra,
                                           inter):
    ta, ja = _links(intra_p)
    tb, jb = _links(inter_p)
    _close(backends.hierarchical_allreduce_time(nbytes, intra, inter, ta, tb),
           j_backends.hierarchical_allreduce_time(nbytes, intra, inter, ja,
                                                  jb))


@pytest.mark.parametrize("params", LINKS)
@pytest.mark.parametrize("sizes", [[], [4096], [1 << 20, 3 << 18, 777],
                                   [1 << 26] * 5])
@pytest.mark.parametrize("ndev,compute_s,k", [(1, 0.0, 1), (8, 1e-3, 1),
                                              (16, 5e-2, 4)])
def test_schedule_cost_functions_equal(params, sizes, ndev, compute_s, k):
    t, j = _links(params)
    _close(backends.per_param_reduce_time(sizes, ndev, t,
                                          compute_s=compute_s),
           j_backends.per_param_reduce_time(sizes, ndev, j,
                                            compute_s=compute_s))
    _close(backends.bucketed_reduce_time(sizes, ndev, t, compute_s=compute_s),
           j_backends.bucketed_reduce_time(sizes, ndev, j,
                                           compute_s=compute_s))
    _close(backends.overlapped_reduce_time(sizes, ndev, t,
                                           compute_s=compute_s,
                                           microbatches=k),
           j_backends.overlapped_reduce_time(sizes, ndev, j,
                                             compute_s=compute_s,
                                             microbatches=k))


def test_link_model_defaults_are_the_cards():
    """NVLink's 450 GB/s each way, no latency (nothing crosses a hop on one
    card), the measured dispatch; the inter-node link ConnectX-7's 50 GB/s."""
    link = backends.LinkModel()
    assert link.bandwidth_Bps == 450e9 and link.latency_s == 0.0
    assert link.dispatch_s > 0
    assert backends.INTER_NODE_LINK.bandwidth_Bps == 50e9
    assert backends.INTER_NODE_LINK.latency_s == 0.0
    for name in ("hierarchical_allreduce_time", "per_param_reduce_time",
                 "bucketed_reduce_time", "overlapped_reduce_time",
                 "ring_allreduce_time", "ring_allgather_time", "LinkModel"):
        assert getattr(ompccl, name) is getattr(backends, name)


def test_analytic_put_adds_the_links_latency():
    mesh = RankMesh(("x",), (4,))
    link = backends.LinkModel(bandwidth_Bps=1e9, latency_s=1e-6)
    inst = backends.AnalyticBackend(link)
    ctx = DiompContext(mesh=mesh, device="cpu")
    ctx.communicator(DiompGroup(("x",)), backend=inst).put(
        torch.zeros(4, 250))
    (est,) = inst.estimates
    assert est["bytes"] == 1000
    _close(est["est_s"], 1000 / 1e9 + 1e-6)


def test_registry_names():
    assert set(backends.available_backends()) >= {
        "xla", "flat", "hierarchical", "analytic"}
    assert backends.get_backend("flat") is backends.XlaBackend
    assert backends.get_backend("hierarchical") is \
        backends.HierarchicalBackend
    ctx = DiompContext(mesh=T_MESH8, device="cpu")
    g = DiompGroup(("pod", "data"), "dp")
    flat, hier = ctx.communicator(g), ctx.communicator(g, "hierarchical")
    assert flat is not hier and flat.calls is hier.calls
    assert hier.backend_name == "hierarchical"


def test_hierarchical_refuses_bad_operands():
    c = DiompContext(mesh=T_MESH8, device="cpu").communicator(
        DiompGroup(("pod", "data")), backend="hierarchical")
    with pytest.raises(ValueError, match="mesh dims"):
        c.allreduce(torch.zeros(2, 2, 3, 4))
    with pytest.raises(ValueError, match="not divisible"):
        c.reducescatter(torch.zeros(2, 2, 2, 6))
    with pytest.raises(ValueError, match="self"):
        hierarchical.hierarchical_allgather(
            torch.zeros(2, 2, 2, 4), DiompGroup(()), T_MESH8)
