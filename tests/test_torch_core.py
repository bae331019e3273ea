"""The port's runtime core held against the JAX package.

Exact parity: group descriptors and algebra, smoke-mesh layouts, one-sided
put/get/halo results, every collective's result, the communicator call and
byte logs, and the PGAS mapping tables under allocator churn.  Collectives
on float data are compared at 1e-6 relative (the two frameworks may sum in
another order); moves (put, get, halo, gather) are compared exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import ompccl as j_ompccl
from repro.core import rma as j_rma
from repro.core.compat import shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.core.groups import merge as j_merge
from repro.core.groups import standard_groups as j_standard_groups
from repro.core.pgas import AllocError as JAllocError
from repro.core.pgas import GlobalMemory as JGlobalMemory
from repro.core.streams import StreamPool as JStreamPool
from repro.launch import mesh as j_mesh

from repro_torch.core import ompccl, rma
from repro_torch.core.backends import AnalyticBackend
from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup, merge, standard_groups
from repro_torch.core.pgas import AllocError, GlobalMemory
from repro_torch.core.rma import RMAError, RMATracker
from repro_torch.core.streams import StreamPool
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.mesh import RankMesh

RNG = np.random.RandomState(0)
AXES8 = ("pod", "data", "model")
T_MESH8 = RankMesh(AXES8, (2, 2, 2))
T_RING8 = RankMesh(("x",), (8,))


def _jax(mesh, fn, x, in_spec, out_spec):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_spec,
                             out_specs=out_spec))(x)


def _np(out):
    return [np.asarray(o) for o in out] if isinstance(out, tuple) \
        else np.asarray(out)


# ---------------------------------------------------------------------------
# groups and meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes,name", [
    (("x",), ""), (("pod", "data"), "dp"), (("pod", "data", "model"), "world"),
    ((), ""), (("model",), "tp")])
def test_group_descriptors_equal(axes, name):
    assert DiompGroup(axes, name).descriptor() == JGroup(axes, name).descriptor()
    assert DiompGroup(axes, name).name == JGroup(axes, name).name


def test_group_split_merge_equal():
    t, j = DiompGroup(AXES8, "world"), JGroup(AXES8, "world")
    for picked in (("model",), ("pod", "model"), ("data",)):
        ts, js = t.split(*picked), j.split(*picked)
        assert [g.descriptor() for g in ts] == [g.descriptor() for g in js]
    tm = merge(DiompGroup(("pod",)), DiompGroup(("model",)))
    jm = j_merge(JGroup(("pod",)), JGroup(("model",)))
    assert tm.descriptor() == jm.descriptor()


@pytest.mark.parametrize("ndev,pods", [(8, True), (8, False), (4, True),
                                       (2, False), (1, False)])
def test_smoke_mesh_layouts_equal(ndev, pods):
    assert t_mesh._smoke_shape(ndev, pods) == j_mesh._smoke_shape(ndev, pods)
    tm = t_mesh.make_smoke_mesh(ndev, pods=pods)
    jm = j_mesh.make_smoke_mesh(ndev, pods=pods)
    assert tm.shape == dict(jm.shape)
    tg, jg = standard_groups(tm), j_standard_groups(jm)
    assert {k: g.descriptor() for k, g in tg.items()} == \
        {k: g.descriptor() for k, g in jg.items()}


def test_production_mesh_shapes():
    assert t_mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert t_mesh.make_production_mesh(multi_pod=True).size == 512


# ---------------------------------------------------------------------------
# one-sided RMA vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [1, -1, 3, 8])
def test_put_get_match_jax(ring8, shift):
    x = RNG.randn(16, 3).astype(np.float32)
    g_j, g_t = JGroup(("x",), "ring"), DiompGroup(("x",), "ring")
    jctx = JContext(mesh=ring8, segment_bytes=1 << 20)
    with j_use_default(jctx):
        want_put = _np(_jax(ring8, lambda v: j_rma.ompx_put(v, g_j, shift=shift),
                            x, P("x"), P("x")))
        want_get = _np(_jax(ring8, lambda v: j_rma.ompx_get(v, g_j, shift=shift),
                            x, P("x"), P("x")))
    ctx = DiompContext(mesh=T_RING8, device="cpu")
    xs = stack_shards(x, T_RING8, ("x", None))
    with use_default(ctx):
        got_put = unstack_shards(rma.ompx_put(xs, g_t, shift=shift), T_RING8,
                                 ("x", None))
        got_get = unstack_shards(rma.ompx_get(xs, g_t, shift=shift), T_RING8,
                                 ("x", None))
    np.testing.assert_array_equal(got_put, want_put)
    np.testing.assert_array_equal(got_get, want_get)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()


def test_put_perm_matches_jax(ring8):
    x = RNG.randn(8, 5).astype(np.float32)
    perm = [(0, 3), (3, 1), (1, 0), (5, 6)]
    g_j, g_t = JGroup(("x",)), DiompGroup(("x",))
    with j_use_default(JContext(mesh=ring8, segment_bytes=1 << 20)):
        want = _np(_jax(ring8, lambda v: j_rma.ompx_put_perm(v, g_j, perm),
                        x, P("x"), P("x")))
    with use_default(DiompContext(mesh=T_RING8, device="cpu")):
        got = rma.ompx_put_perm(stack_shards(x, T_RING8, ("x", None)), g_t,
                                perm)
    np.testing.assert_array_equal(unstack_shards(got, T_RING8, ("x", None)),
                                  want)


@pytest.mark.parametrize("halo,rows", [(1, 3), (2, 2), (3, 5)])
def test_halo_exchange_matches_jax(ring8, halo, rows):
    x = RNG.randn(8 * rows, 4).astype(np.float32)
    g_j, g_t = JGroup(("x",), "ring"), DiompGroup(("x",), "ring")
    jctx = JContext(mesh=ring8, segment_bytes=1 << 20)

    def j_fn(v):
        lo, hi = j_rma.halo_exchange(v, g_j, halo=halo, axis=0)
        return jnp.concatenate([lo, hi], axis=0)

    with j_use_default(jctx):
        want = _np(_jax(ring8, j_fn, x, P("x"), P("x")))
    ctx = DiompContext(mesh=T_RING8, device="cpu")
    with use_default(ctx):
        lo, hi = rma.halo_exchange(stack_shards(x, T_RING8, ("x", None)), g_t,
                                   halo=halo, axis=0)
    got = unstack_shards(torch.cat([lo, hi], dim=1), T_RING8, ("x", None))
    np.testing.assert_array_equal(got, want)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()
    for attr in ("puts", "fences", "put_bytes", "window_bytes"):
        assert getattr(ctx.rma, attr) == getattr(jctx.rma, attr), attr


def test_halo_wider_than_shard_rejected():
    ctx = DiompContext(mesh=T_RING8, device="cpu")
    with use_default(ctx), pytest.raises(RMAError):
        rma.halo_exchange(torch.zeros(8, 2, 3), DiompGroup(("x",)), halo=3)


# ---------------------------------------------------------------------------
# collectives + call/byte logs vs JAX
# ---------------------------------------------------------------------------

GROUPS = [AXES8, ("pod", "data"), ("model",), ("data", "model")]


@pytest.mark.parametrize("axes", GROUPS)
def test_collectives_match_jax(mesh8, axes):
    x = RNG.randn(8 * 4, 8).astype(np.float32)
    spec_j = P(AXES8)
    g_j, g_t = JGroup(axes), DiompGroup(axes)
    jctx = JContext(mesh=mesh8, segment_bytes=1 << 20)

    def j_fn(v):
        c = jctx.communicator(g_j)
        return (c.allreduce(v), c.allreduce(v, op="max"), c.bcast(v, root=1),
                c.reduce(v, root=1), c.allgather(v, axis=0),
                c.allgather(v, axis=1, tiled=False),
                c.reducescatter(v, axis=1), c.alltoall(v, split_axis=1,
                                                       concat_axis=0))

    want = _np(jax.jit(shard_map(j_fn, mesh=mesh8, in_specs=spec_j,
                                 out_specs=(spec_j,) * 8))(x))
    ctx = DiompContext(mesh=T_MESH8, device="cpu")
    c = ctx.communicator(g_t)
    xs = stack_shards(x, T_MESH8, (AXES8, None))
    outs = (c.allreduce(xs), c.allreduce(xs, op="max"), c.bcast(xs, root=1),
            c.reduce(xs, root=1), c.allgather(xs, axis=0),
            c.allgather(xs, axis=1, tiled=False), c.reducescatter(xs, axis=1),
            c.alltoall(xs, split_axis=1, concat_axis=0))
    for i, (o, w) in enumerate(zip(outs, want)):
        got = unstack_shards(o, T_MESH8, (AXES8,) + (None,) * (o.dim() - 4))
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6,
                                   err_msg=f"verb {i}")
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()


def test_free_function_call_and_byte_logs_match_jax(ring8):
    """The seed's call-count semantics (reduce -> reduce + allreduce, get ->
    get + put, put_perm -> put) and per-rank byte volumes, both packages."""
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    g_j, g_t = JGroup(("x",), "ring"), DiompGroup(("x",), "ring")
    perm = [(i, i) for i in range(8)]

    def j_ops(v):
        a = j_ompccl.allreduce(v, g_j)
        r = j_ompccl.reduce(v, g_j, root=0)
        b = j_ompccl.bcast(v, g_j, root=0)
        ag = j_ompccl.allgather(v, g_j, axis=0)
        rs = j_ompccl.reducescatter(ag, g_j, axis=0)
        pm = j_ompccl.permute(v, g_j, shift=1)
        bar = j_ompccl.barrier_value(g_j)
        p = j_rma.ompx_put(v, g_j, shift=1)
        gq = j_rma.ompx_get(v, g_j, shift=1)
        pp = j_rma.ompx_put_perm(v, g_j, perm)
        h0, h1 = j_rma.halo_exchange(v, g_j, halo=1, axis=0)
        return a + r + b + rs + pm + p + gq + pp + h0 + h1 + 0 * bar

    jctx = JContext(mesh=ring8, segment_bytes=1 << 20)
    with j_use_default(jctx):
        want = np.asarray(_jax(ring8, j_ops, x, P("x"), P("x")))
    ctx = DiompContext(mesh=T_RING8, device="cpu")
    xs = stack_shards(x, T_RING8, ("x", None))
    with use_default(ctx):
        a = ompccl.allreduce(xs, g_t)
        r = ompccl.reduce(xs, g_t, root=0)
        b = ompccl.bcast(xs, g_t, root=0)
        rs = ompccl.reducescatter(ompccl.allgather(xs, g_t, axis=0), g_t,
                                  axis=0)
        pm = ompccl.permute(xs, g_t, shift=1)
        ompccl.barrier_value(g_t)
        p = rma.ompx_put(xs, g_t, shift=1)
        gq = rma.ompx_get(xs, g_t, shift=1)
        pp = rma.ompx_put_perm(xs, g_t, perm)
        h0, h1 = rma.halo_exchange(xs, g_t, halo=1, axis=0)
        got = a + r + b + rs + pm + p + gq + pp + h0 + h1
    np.testing.assert_allclose(unstack_shards(got, T_RING8, ("x", None)),
                               want, rtol=1e-6)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()
    assert ctx.retry_stats() == {}


def test_analytic_backend_logs_reference_bytes(ring8):
    x = RNG.randn(8 * 3, 5).astype(np.float32)
    g_j, g_t = JGroup(("x",)), DiompGroup(("x",))
    jctx = JContext(mesh=ring8, segment_bytes=1 << 20)
    jc = jctx.communicator(g_j, backend="analytic")
    _jax(ring8, lambda v: jc.put(jc.permute(jc.allreduce(v))), x, P("x"),
         P("x"))
    ctx = DiompContext(mesh=T_RING8, device="cpu")
    tc = ctx.communicator(g_t, backend="analytic")
    tc.put(tc.permute(tc.allreduce(stack_shards(x, T_RING8, ("x", None)))))
    strip = [{k: e[k] for k in ("op", "bytes", "ndev")}
             for e in jc.backend.estimates]
    assert [{k: e[k] for k in ("op", "bytes", "ndev")}
            for e in tc.backend.estimates] == strip
    assert isinstance(tc.backend, AnalyticBackend)
    assert all(e["est_s"] > 0 for e in tc.backend.estimates)


def test_fault_plan_not_ported_yet():
    """(Kept name: the context took no plan before fault injection was
    ported.)  A context carries its plan: every backend it creates is
    chaos-wrapped, with the reference's name, and its retries are counted
    as the reference's context counts them."""
    from repro.core.faults import FaultPlan as JFaultPlan
    from repro.core.resilience import RetryPolicy as JRetryPolicy
    from repro_torch.core.faults import ChaosBackend, FaultPlan
    from repro_torch.core.resilience import RetryPolicy
    plan = FaultPlan(5, p=0.5, kinds=("drop", "timeout"))
    ctx = DiompContext(mesh=T_RING8, device="cpu", fault_plan=plan,
                       retry_policy=RetryPolicy(sleep=False))
    jctx = JContext(segment_bytes=1 << 20,
                    fault_plan=JFaultPlan(5, p=0.5, kinds=("drop", "timeout")),
                    retry_policy=JRetryPolicy(sleep=False))
    g_t, g_j = DiompGroup(("x",)), JGroup(("x",))
    comm, jcomm = ctx.communicator(g_t), jctx.communicator(g_j)
    assert ctx.fault_plan is plan and comm.policy is ctx.retry_policy
    assert isinstance(comm.backend, ChaosBackend)
    assert comm.backend_name == jcomm.backend_name == "chaos:xla"
    assert ctx.communicator(g_t, "hierarchical").backend_name \
        == jctx.communicator(g_j, "hierarchical").backend_name
    xs = stack_shards(RNG.randn(8, 3).astype(np.float32), T_RING8,
                      ("x", None))
    for _ in range(4):
        got = comm.allreduce(xs)
    calm = DiompContext(mesh=T_RING8, device="cpu",
                        fault_plan=FaultPlan(0)).communicator(g_t)
    assert torch.equal(got, calm.allreduce(xs))
    assert [(f.call_index, f.kind, f.recovered) for f in plan.injected] \
        == [(0, "drop", True), (1, "drop", True), (5, "timeout", True)]
    assert ctx.retry_stats() == {g_t.descriptor(): {
        "allreduce": len(plan.injected)}}
    assert ctx.retry_byte_stats() == {g_t.descriptor(): {
        "allreduce": len(plan.injected) * 3 * 4}}
    assert ctx.stats() == {g_t.descriptor(): {"allreduce": 4}}


def test_use_default_scopes_and_restores():
    a = DiompContext(device="cpu")
    b = DiompContext(device="cpu")
    from repro_torch.core.context import default_context
    with use_default(a):
        assert default_context() is a
        with use_default(b):
            assert default_context() is b
        assert default_context() is a


# ---------------------------------------------------------------------------
# PGAS: identical tables under the churn sequences of tests/test_pgas.py
# ---------------------------------------------------------------------------


def _table(gm):
    return [(r["rid"], r["name"], r["symmetric"], tuple(r["bytes"]),
             tuple(r["offsets"]), r["group"], tuple(r["logical_axes"]),
             r["dtype"]) for r in gm.mapping_table()]


def _churn(gm, group, ops, alloc_error):
    trace, live = [], []
    for i, (kind, size) in enumerate(ops):
        try:
            if kind == 0 or not live:
                live.append(gm.alloc_symmetric(f"s{i}", size, group))
            elif kind == 1:
                live.append(gm.alloc_asymmetric(
                    f"a{i}", [size, size // 2 + 1, size * 2, 1], group))
            else:
                gm.free(live.pop(len(live) // 2))
            trace.append("ok")
        except alloc_error:
            trace.append("oom")
        trace.append(tuple(gm.bytes_in_use(r) for r in range(4)))
    for h in live[::2]:
        gm.translate(h, 1)
        gm.translate(h, 1)
    return trace


@pytest.mark.parametrize("allocator", ["linear", "buddy"])
@pytest.mark.parametrize("seed", range(6))
def test_pgas_tables_equal_under_churn(allocator, seed):
    rng = np.random.RandomState(seed)
    ops = [(int(rng.randint(0, 4)), int(rng.randint(1, 3001)))
           for _ in range(int(rng.randint(1, 51)))]
    jm = JGlobalMemory(4, 1 << 15, allocator=allocator)
    tm = GlobalMemory(4, 1 << 15, allocator=allocator)
    jt = _churn(jm, JGroup(("x",), "x"), ops, JAllocError)
    tt = _churn(tm, DiompGroup(("x",), "x"), ops, AllocError)
    assert tt == jt
    assert _table(tm) == _table(jm)
    assert tm.alloc_counts == jm.alloc_counts
    assert (tm.ptr_cache.hits, tm.ptr_cache.misses) == \
        (jm.ptr_cache.hits, jm.ptr_cache.misses)
    tm.check_invariants()


def test_pgas_rollback_matches_reference():
    for gm, g, err in ((JGlobalMemory(4, 4096), JGroup(("x",)), JAllocError),
                       (GlobalMemory(4, 4096), DiompGroup(("x",)), AllocError)):
        keep = gm.alloc_asymmetric("warm", [256, 256, 3328, 256], g)
        before = [gm.bytes_in_use(r) for r in range(4)]
        with pytest.raises(err):
            gm.alloc_asymmetric("boom", [128, 128, 2048, 128], g)
        assert [gm.bytes_in_use(r) for r in range(4)] == before
        gm.free(keep)
        assert all(gm.bytes_in_use(r) == 0 for r in range(4))


# ---------------------------------------------------------------------------
# streams + tracker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,budget,max_active", [
    (0, 1 << 20, 8), (1000, 1 << 20, 8), (1 << 19, 1 << 20, 8),
    (1 << 21, 1 << 20, 8), (100, 1 << 20, 3)])
def test_plan_slots_equal(ws, budget, max_active):
    assert StreamPool(max_active).plan_slots(ws, budget) == \
        JStreamPool(max_active).plan_slots(ws, budget)


def test_stream_pool_runs_host_work():
    pool = StreamPool(max_active=2)
    futs = [pool.submit(lambda i=i: i * i) for i in range(6)]
    assert [f.result(timeout=10) for f in futs] == [i * i for i in range(6)]
    pool.close()


def test_rma_tracker_discipline():
    tr = RMATracker()
    tr.register("w")
    tr.on_put("w", 64)
    with pytest.raises(RMAError):
        tr.on_read("w")
    tr.on_fence("w")
    tr.on_read("w")
    assert (tr.puts, tr.put_bytes, tr.fences) == (1, 64, 1)
