"""The port's fault injection and retry layer held against the JAX package's.

* ``FaultPlan``: for the same seed and per-verb call sequence the port's
  plan injects the reference's exact ``(verb, call_index, kind)`` stream
  (several seeds, probabilities, explicit specs and ``max_faults``), from
  the ``DIOMP_CHAOS_*`` environment too; a scheduled death fires once.
* ``ChaosBackend`` delegates each verb directly: a ``bcast`` fault rolls
  ``bcast`` alone.
* The communicator's retries: the reference's verb sweep, the ring matmul,
  the Minimod fused step and the MoE dispatch run bit-identical to a calm
  run under chaos, with unchanged call and byte logs, one retry a fault,
  and the reference's injected stream on the same inputs; a whole
  ``run_minimod`` under its ``fault_plan`` bit for bit its calm run.
* Each fused kernel's put logger (its route on the card) injects, logs
  and retries exactly as its ``ompx_put`` emulation; backward passes
  neither roll nor log.
* A validated page migration through a real communicator repairs corrupt
  transfers and accounts the retries; the scratch context that replayed
  passes log against injects nothing, whatever the environment says.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.apps.minimod import pad_shards as j_pad_shards
from repro.apps.minimod import unpad_shards as j_unpad_shards
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.core.groups import DiompGroup as JGroup
from repro.core.pgas import GlobalMemory as JGlobalMemory
from repro.core.resilience import RetryPolicy as JRetryPolicy
from repro.kernels.ring_matmul.ops import \
    ring_allgather_matmul as j_ring_matmul
from repro.kernels.stencil.fused import fused_wave_step as j_fused_wave_step
from repro.serve.kvcache import PagedKVAllocator as JAlloc

from repro_torch.apps.minimod import run_minimod
from repro_torch.core.backends import XlaBackend
from repro_torch.core.context import (DiompContext, recorded_once,
                                      scratch_context, use_default)
from repro_torch.core.faults import (INJECTABLE_VERBS, TRANSIENT_KINDS,
                                     ChaosBackend, FaultPlan, FaultSpec)
from repro_torch.core.groups import DiompGroup
from repro_torch.core.pgas import GlobalMemory
from repro_torch.core.resilience import (RetryError, RetryPolicy,
                                         TransientFault)
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels.moe_dispatch import fused as t_moe
from repro_torch.kernels.plan import AttentionRingPlan, OverlapPlanner
from repro_torch.kernels.ring_attention import fused as t_ring_attn
from repro_torch.kernels.ring_matmul import fused as t_ring_mm
from repro_torch.kernels.ring_matmul.ops import ring_allgather_matmul
from repro_torch.kernels.stencil import fused as t_stencil
from repro_torch.launch.mesh import RankMesh
from repro_torch.serve.kvcache import PagedKVAllocator

from test_faults import _verb_sweep as j_verb_sweep
from test_torch_moe_dispatch import _dispatch_case, _run_port, _run_ref

RNG = np.random.RandomState(3)
KINDS = ("drop", "fail", "timeout")
FAST = RetryPolicy(sleep=False)
J_FAST = JRetryPolicy(sleep=False)
RING8 = RankMesh(("x",), (8,))
T_RING = DiompGroup(("x",), name="x")
J_RING = JGroup(("x",), name="x")


def _calm(mesh):
    return DiompContext(mesh=mesh, device="cpu", fault_plan=FaultPlan(0))


def _chaos(mesh, seed, p=0.3, **kw):
    plan = FaultPlan(seed, p=p, kinds=KINDS)
    return DiompContext(mesh=mesh, device="cpu", fault_plan=plan,
                        retry_policy=FAST, **kw), plan


def _j_chaos(mesh, seed, p=0.3):
    plan = JFaultPlan(seed, p=p, kinds=KINDS)
    return JContext(mesh=mesh, segment_bytes=1 << 20, fault_plan=plan,
                    retry_policy=J_FAST), plan


def _stream(plan):
    return [(f.verb, f.call_index, f.kind) for f in plan.injected]


def _total(stats):
    return sum(sum(ops.values()) for ops in stats.values())


def _books(ctx):
    return (ctx.stats(), ctx.byte_stats(), ctx.retry_stats(),
            ctx.retry_byte_stats(), ctx.rma.puts, ctx.rma.put_bytes,
            ctx.rma.fences, dict(ctx.rma.window_bytes))


def _recovered(ctx, plan):
    """Faults were injected, every one recovered, one retry each."""
    assert plan.injected and plan.unrecovered() == []
    assert _total(ctx.retry_stats()) == len(plan.injected)


# ---------------------------------------------------------------------------
# the plan: the reference's stream
# ---------------------------------------------------------------------------

def _drive(plan, verbs, n):
    return [None if f is None else (f.verb, f.call_index, f.kind)
            for verb in verbs for f in
            (plan.next_fault(verb) for _ in range(n))]


PLANS = {
    "p05": dict(seed=7, p=0.5, kinds=KINDS),
    "p02_all_kinds": dict(seed=11, p=0.2, kinds=TRANSIENT_KINDS),
    "p1_drop": dict(seed=1, p=1.0),
    "specs": dict(seed=0, specs=(("put", 0, "corrupt"), ("bcast", 3, "fail"),
                                 ("migrate", 2, "delay"))),
    "specs_and_p": dict(seed=23, p=0.3, kinds=("fail", "timeout"),
                        specs=(("allreduce", 1, "drop"),)),
    "max_faults": dict(seed=5, p=0.6, kinds=KINDS, max_faults=4),
    "verbs_subset": dict(seed=9, p=0.5, verbs=("put", "permute")),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_stream_equals_reference(name):
    kw = dict(PLANS[name])
    seed = kw.pop("seed")
    specs = kw.pop("specs", ())
    mine = FaultPlan(seed, specs=tuple(FaultSpec(*s) for s in specs), **kw)
    ref = JFaultPlan(seed, specs=tuple(JFaultSpec(*s) for s in specs), **kw)
    # interleaved verbs: the counters are per verb
    got = _drive(mine, INJECTABLE_VERBS, 6) + _drive(mine, ("put",) * 3, 2)
    want = _drive(ref, INJECTABLE_VERBS, 6) + _drive(ref, ("put",) * 3, 2)
    assert got == want and any(got)
    assert mine.injected_counts() == ref.injected_counts()
    mine.reset_counters()
    ref.reset_counters()
    assert _drive(mine, ("put",), 4) == _drive(ref, ("put",), 4)


def test_plan_from_env_equals_reference(monkeypatch):
    monkeypatch.delenv("DIOMP_CHAOS_SEED", raising=False)
    assert FaultPlan.from_env() is None
    monkeypatch.setenv("DIOMP_CHAOS_SEED", "31")
    monkeypatch.setenv("DIOMP_CHAOS_P", "0.4")
    monkeypatch.setenv("DIOMP_CHAOS_KINDS", "fail,timeout")
    monkeypatch.setenv("DIOMP_CHAOS_VERBS", "put,allreduce,alltoall")
    mine, ref = FaultPlan.from_env(), JFaultPlan.from_env()
    assert (mine.seed, mine.p, mine.kinds, mine.verbs) \
        == (ref.seed, ref.p, ref.kinds, ref.verbs) \
        == (31, 0.4, ("fail", "timeout"), ("put", "allreduce", "alltoall"))
    assert _drive(mine, INJECTABLE_VERBS, 5) == _drive(ref, INJECTABLE_VERBS, 5)
    # the ambient plan is the context's default, and wraps its backends
    ctx = DiompContext(mesh=RING8, device="cpu")
    assert ctx.fault_plan is not None and ctx.fault_plan.seed == 31
    assert ctx.communicator(T_RING).backend_name == "chaos:xla"


def test_kill_rank_fires_once():
    plan = FaultPlan(0).kill_rank(3, rank=2).kill_rank(5, rank=1,
                                                       graceful=True)
    assert plan.deaths_at(2) == []
    (d,) = plan.deaths_at(4)
    assert (d.step, d.rank, d.graceful, d.fired) == (3, 2, False, True)
    assert plan.deaths_at(4) == []
    (d,) = plan.deaths_at(9)
    assert (d.rank, d.graceful) == (1, True)
    assert plan.deaths_at(9) == [] and plan.deaths_at(100) == []


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(0, kinds=("melt",))
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("put", 0, "melt")


# ---------------------------------------------------------------------------
# the backend wrapper and the communicator's retries
# ---------------------------------------------------------------------------

def test_chaos_backend_delegates_each_verb_directly():
    plan = FaultPlan(5, specs=(FaultSpec("bcast", 0, "fail"),))
    cb = ChaosBackend(XlaBackend(), plan)
    assert cb.name == "chaos:xla"
    x = torch.arange(8.0).reshape(8, 1)
    with pytest.raises(TransientFault):
        cb.bcast(x, T_RING, RING8, root=2)
    # only the bcast roll fired: delegation never touched allreduce
    assert [f.verb for f in plan.injected] == ["bcast"]
    assert plan._counters == {"bcast": 1}
    got = cb.bcast(x, T_RING, RING8, root=2)
    assert torch.equal(got, XlaBackend().bcast(x, T_RING, RING8, root=2))
    assert plan._counters == {"bcast": 2}


def _t_verb_sweep(ctx):
    """The reference's sweep (``tests/test_faults.py``) on stacked ranks."""
    comm = ctx.communicator(T_RING)
    x = stack_shards(np.arange(32, dtype=np.float32).reshape(8, 4), RING8,
                     ("x", None))
    y = comm.allreduce(x)
    y = y + comm.bcast(x, root=1)
    y = y + comm.permute(x, shift=1)
    y = y + comm.put(x, shift=2)
    lo, hi = comm.halo_exchange(x, halo=1, axis=0)
    y = y + lo + hi
    y = y + comm.reducescatter(comm.allgather(x, axis=0), axis=0)
    y = y + 0 * comm.barrier().reshape(8, 1, 1)
    return unstack_shards(y, RING8, ("x", None))


@pytest.mark.parametrize("seed", [11, 12, 29])
def test_verb_sweep_bit_identical_under_chaos(ring8, seed):
    calm = _calm(RING8)
    chaos, plan = _chaos(RING8, seed)
    want = _t_verb_sweep(calm)
    got = _t_verb_sweep(chaos)
    assert np.array_equal(got, want)
    _recovered(chaos, plan)
    assert chaos.stats() == calm.stats()
    assert chaos.byte_stats() == calm.byte_stats()
    assert calm.retry_stats() == {} and calm.retry_byte_stats() == {}
    # the reference's sweep under the same seed: the same stream, the
    # same logical and retry logs
    jctx, jplan = _j_chaos(ring8, seed)
    ref = j_verb_sweep(jctx, ring8)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert _stream(plan) == _stream(jplan)
    assert chaos.stats() == jctx.stats()
    assert chaos.retry_stats() == jctx.retry_stats()


def test_retry_budget_exhaustion_surfaces():
    plan = FaultPlan(1, p=1.0, kinds=("drop",))
    ctx = DiompContext(mesh=RING8, device="cpu", fault_plan=plan,
                       retry_policy=RetryPolicy(max_retries=2, sleep=False))
    with pytest.raises(RetryError):
        ctx.communicator(T_RING).allreduce(torch.ones(8, 4))
    # the first attempt and two retries rolled, then the error surfaced
    assert len(plan.injected) == 3 and len(plan.unrecovered()) == 3
    assert ctx.retry_stats() == {T_RING.descriptor(): {"allreduce": 2}}
    assert ctx.stats() == {T_RING.descriptor(): {"allreduce": 1}}


def test_caller_owned_backend_is_not_wrapped():
    ctx, _ = _chaos(RING8, 3)
    mine = XlaBackend()
    assert ctx.communicator(T_RING, backend=mine).backend is mine
    assert isinstance(ctx.communicator(T_RING).backend, ChaosBackend)
    assert isinstance(ctx.communicator(T_RING, "hierarchical").backend,
                      ChaosBackend)


def test_context_carries_a_plan_and_policy():
    plan, pol = FaultPlan(4, p=0.1), RetryPolicy(max_retries=3)
    ctx = DiompContext(mesh=RING8, device="cpu", fault_plan=plan,
                       retry_policy=pol)
    comm = ctx.communicator(T_RING)
    assert ctx.fault_plan is plan and ctx.retry_policy is pol
    assert comm.policy is pol and comm.backend.plan is plan
    ctx.reset_stats()
    assert ctx.retry_stats() == {}


# ---------------------------------------------------------------------------
# the fused paths under an injecting default context
# ---------------------------------------------------------------------------

def test_ring_matmul_bit_identical_under_chaos():
    n = 8
    A = RNG.randn(16, 24).astype(np.float32)
    B = RNG.randn(24, 16).astype(np.float32)
    mesh = RankMesh(("x",), (n,))
    x = stack_shards(A, mesh, ("x", None))
    w = stack_shards(B, mesh, (None, "x"))

    def run(ctx, impl):
        with use_default(ctx):
            return ring_allgather_matmul(x, w, T_RING, impl=impl)

    jmesh = make_mesh((n,), ("x",), axis_types="auto")
    for impl, seed in (("fused", 13), ("host", 14)):
        calm = _calm(mesh)
        want = run(calm, impl)
        chaos, plan = _chaos(mesh, seed)
        got = run(chaos, impl)
        assert torch.equal(got, want)
        _recovered(chaos, plan)
        assert chaos.stats() == calm.stats()
        assert chaos.byte_stats() == calm.byte_stats()
        jctx, jplan = _j_chaos(jmesh, seed)
        f = jax.jit(shard_map(
            lambda a, b: j_ring_matmul(a, b, J_RING, impl=impl),
            mesh=jmesh, in_specs=(P("x", None), P(None, "x")),
            out_specs=P(None, "x")))
        with j_use_default(jctx):
            ref = np.asarray(f(A, B))
        np.testing.assert_allclose(unstack_shards(got, mesh, (None, "x")),
                                   ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        assert _stream(plan) == _stream(jplan)
        assert chaos.retry_stats() == jctx.retry_stats()


def test_minimod_step_bit_identical_under_chaos():
    Z, Y, X, nz = 32, 8, 8, 4
    ext = (Z // nz,) * nz
    u = (RNG.randn(Z, Y, X) * 0.1).astype(np.float32)
    up = (RNG.randn(Z, Y, X) * 0.1).astype(np.float32)
    u_in, up_in = j_pad_shards(u, ext), j_pad_shards(up, ext)
    mesh = RankMesh(("z", "y"), (nz, 1))
    spec = ("z", "y", None)
    a, b = (stack_shards(t, mesh, spec) for t in (u_in, up_in))
    zg = DiompGroup(("z",), "z")

    def run(ctx):
        with use_default(ctx):
            return t_stencil.fused_wave_step(a, b, 0.1, zg, None)

    calm = _calm(mesh)
    want = run(calm)
    chaos, plan = _chaos(mesh, 17)
    got = run(chaos)
    assert torch.equal(got, want)
    _recovered(chaos, plan)
    assert _books(chaos)[:2] == _books(calm)[:2]
    assert _books(chaos)[4:] == _books(calm)[4:]
    jmesh = make_mesh((nz, 1), ("z", "y"), axis_types="auto")
    jctx, jplan = _j_chaos(jmesh, 17)
    jzg = JGroup(("z",), "z")
    f = jax.jit(shard_map(
        lambda p, q: j_fused_wave_step(p, q, 0.1, jzg, None), mesh=jmesh,
        in_specs=(P("z", "y"), P("z", "y")), out_specs=P("z", "y")))
    with j_use_default(jctx):
        ref = j_unpad_shards(np.asarray(f(u_in, up_in)), ext)
    mine = j_unpad_shards(unstack_shards(got, mesh, spec), ext)
    np.testing.assert_allclose(mine, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())
    assert _stream(plan) == _stream(jplan)
    assert chaos.retry_stats() == jctx.retry_stats()


MINIMOD_BOOKS = ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
                 "fences", "window_bytes")


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_run_minimod_bit_identical_under_chaos(mode, monkeypatch):
    """``run_minimod(fault_plan=)``: the whole run bit for bit the calm
    run's, its books equal, one retry a fault; under an ambient plan too,
    since the run's replay context is inert."""
    monkeypatch.setenv("DIOMP_CHAOS_SEED", "5")
    monkeypatch.setenv("DIOMP_CHAOS_P", "0.9")
    u0 = (RNG.randn(32, 8, 8) * 0.1).astype(np.float32)
    up0 = (RNG.randn(32, 8, 8) * 0.1).astype(np.float32)

    def run(plan):
        return run_minimod(grid=(32, 8, 8), nz=4, steps=3, mode=mode,
                           u0=u0, u_prev0=up0, device="cpu",
                           fault_plan=plan, retry_policy=FAST)

    calm = run(FaultPlan(0))
    plan = FaultPlan(36, p=0.3, kinds=KINDS)
    got = run(plan)
    assert torch.equal(got.field, calm.field)
    assert all(getattr(got, a) == getattr(calm, a) for a in MINIMOD_BOOKS)
    assert calm.retries == calm.retry_bytes == 0
    assert plan.injected and plan.unrecovered() == []
    assert got.retries == len(plan.injected) and got.retry_bytes > 0


@pytest.mark.parametrize("impl", ["host", "fused"])
def test_moe_dispatch_bit_identical_under_chaos(impl):
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=32)
    mesh = RankMesh(("x",), (4,))
    calm = _calm(mesh)
    want = _run_port(c, impl, c["tplan"], calm)
    chaos, plan = _chaos(mesh, 19, p=0.25)
    got = _run_port(c, impl, c["tplan"], chaos)
    assert torch.equal(torch.as_tensor(got[0]), torch.as_tensor(want[0]))
    assert got[1:] == want[1:]
    _recovered(chaos, plan)
    assert chaos.stats() == calm.stats()
    assert chaos.byte_stats() == calm.byte_stats()
    jctx, jplan = _j_chaos(make_mesh((4,), ("x",), axis_types="auto"), 19,
                           p=0.25)
    ref, _ = _run_ref(c, impl, c["jplan"], jctx)
    np.testing.assert_allclose(got[0], ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert _stream(plan) == _stream(jplan)
    assert chaos.retry_stats() == jctx.retry_stats()


# ---------------------------------------------------------------------------
# the kernel routes' put loggers against their emulations
# ---------------------------------------------------------------------------

def _ring_matmul_pair():
    n = 6
    mesh = RankMesh(("x",), (n,))
    x, w = torch.randn(n, 4, 12), torch.randn(n, 12, 3)
    plan = OverlapPlanner().plan_ring_matmul(4, 12, 3, torch.float32, n)
    return (mesh,
            lambda: t_ring_mm.fused_ring_allgather_matmul_emulated(
                x, w, T_RING, plan=plan),
            lambda: t_ring_mm._record_traffic(x, T_RING, plan))


def _stencil_pair(carried):
    nz = 4
    mesh = RankMesh(("z", "y"), (nz, 1))
    zg = DiompGroup(("z",), "z")
    u, up = torch.randn(nz, 1, 12, 10, 8), torch.randn(nz, 1, 12, 10, 8)
    if carried:
        with use_default(_calm(mesh)):
            h = t_stencil.exchange_halos(u, zg)

        def emulated():
            t_stencil.fused_wave_step(u, up, 0.1, zg, halos=h,
                                      return_halos=True)
    else:
        def emulated():
            t_stencil.fused_wave_step(u, up, 0.1, zg)
    return mesh, emulated, lambda: t_stencil._record_single_step(u, zg)


def _moe_pair():
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=16)
    mesh = RankMesh(("x",), (4,))
    spec = ("x", None)
    toks, te, tw = (stack_shards(a, mesh, spec) for a in
                    (c["toks"], c["te"].numpy(), c["tw"].numpy()))
    ws = [stack_shards(w, mesh, ("x", None, None)) for w in c["ws"]]
    plan = c["tplan"]

    def recorded():
        buf = t_moe.dispatch_buffers(toks, te, tw, plan)[0]
        t_moe._record_traffic(buf.select(mesh.ndim, 0), T_RING, plan)

    return (mesh,
            lambda: t_moe.fused_moe_dispatch_interpret(
                toks, te, tw, *ws, T_RING, plan=plan),
            recorded)


def _ring_attention_pair():
    n, B, tq, H, KH, D = 4, 2, 4, 4, 2, 8
    mesh = RankMesh(("x",), (n,))
    q = torch.randn(n, B, tq, H, D)
    k, v = torch.randn(n, B, tq, KH, D), torch.randn(n, B, tq, KH, D)
    plan = OverlapPlanner().plan_ring_attention(B, tq, tq, H, KH, D, D,
                                                torch.float32, n)
    assert isinstance(plan, AttentionRingPlan)
    return (mesh,
            lambda: t_ring_attn.fused_ring_attention_interpret(
                q, k, v, T_RING, plan=plan),
            lambda: t_ring_attn._record_traffic(k, v, T_RING, plan))


PAIRS = {"ring_matmul": _ring_matmul_pair,
         "stencil_single": lambda: _stencil_pair(False),
         "stencil_carried": lambda: _stencil_pair(True),
         "moe_dispatch": _moe_pair,
         "ring_attention": _ring_attention_pair}


@pytest.mark.parametrize("seed", [2, 41])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_kernel_route_put_logger_equals_emulation(name, seed):
    """The kernel route logs its schedule's puts before the launch; with
    the same plan it injects, logs and retries as the emulation does."""
    mesh, emulated, recorded = PAIRS[name]()
    books, streams = [], []
    for run in (emulated, recorded):
        ctx, plan = _chaos(mesh, seed, p=0.5)
        with use_default(ctx):
            run()
        books.append(_books(ctx))
        streams.append(_stream(plan))
        _recovered(ctx, plan)
        assert {f.verb for f in plan.injected} == {"put"}
    assert streams[0] == streams[1]
    assert books[0] == books[1]


def test_kernel_put_without_chaos_only_records():
    ctx = _calm(RING8)
    comm = ctx.communicator(T_RING)
    comm.kernel_put(torch.ones(8, 4))
    assert ctx.stats() == {T_RING.descriptor(): {"put": 1}}
    assert ctx.byte_stats() == {T_RING.descriptor(): {"put": 16}}
    assert ctx.fault_plan.injected == [] and ctx.retry_stats() == {}


def test_ring_attention_backward_neither_rolls_nor_logs():
    """The emulated ring's VJP replays the arrivals without the
    communicator: after a forward and a backward the plan has rolled, and
    the books hold, the forward's puts alone."""
    mesh, emulated, _ = _ring_attention_pair()
    n, B, tq, H, KH, D = 4, 2, 4, 4, 2, 8
    q = torch.randn(n, B, tq, H, D, requires_grad=True)
    k = torch.randn(n, B, tq, KH, D, requires_grad=True)
    v = torch.randn(n, B, tq, KH, D, requires_grad=True)
    plan = OverlapPlanner().plan_ring_attention(B, tq, tq, H, KH, D, D,
                                                torch.float32, n)
    fwd, fplan = _chaos(mesh, 8, p=0.5)
    with use_default(fwd):
        t_ring_attn.fused_ring_attention_interpret(
            q.detach(), k.detach(), v.detach(), T_RING, plan=plan)
    both, bplan = _chaos(mesh, 8, p=0.5)
    with use_default(both):
        out = t_ring_attn.fused_ring_attention_interpret(q, k, v, T_RING,
                                                         plan=plan)
        out.sum().backward()
    assert q.grad is not None and k.grad is not None
    assert bplan._counters == fplan._counters
    assert _stream(bplan) == _stream(fplan)
    assert _books(both) == _books(fwd)


# ---------------------------------------------------------------------------
# the validated migration through a real communicator
# ---------------------------------------------------------------------------

def _migrate(alloc_cls, memory_cls, group, ctx, plan, policy):
    alloc = alloc_cls(memory_cls(4, 1 << 22, allocator="buddy"), group,
                      page_tokens=16, kv_bytes_per_token=64)
    req = alloc.admit(30, 60, home_rank=0)
    ctx.rma.register("w")
    moved = alloc.migrate(req, 3, comm=ctx.communicator(group),
                          tracker=ctx.rma, window="w", faults=plan,
                          policy=policy, validate=True)
    return alloc, req, moved


def test_validated_migrate_through_a_communicator():
    """The migration accounts a repaired page through the communicator's
    ``record_retry``; the port's communicator lacked it, so a retried page
    transfer raised AttributeError."""
    specs = (("migrate", 0, "corrupt"), ("migrate", 2, "corrupt"),
             ("migrate", 3, "drop"))
    mesh = RankMesh(("x",), (4,))
    ctx = DiompContext(mesh=mesh, device="cpu", fault_plan=FaultPlan(0))
    plan = FaultPlan(0, specs=tuple(FaultSpec(*s) for s in specs))
    alloc, req, moved = _migrate(PagedKVAllocator, GlobalMemory, T_RING, ctx,
                                 plan, FAST)
    npages = len(req.page_table)
    assert moved == npages * alloc.page_bytes and req.home_rank == 3
    world = T_RING.descriptor()
    assert ctx.stats() == {world: {"get": npages, "put": npages}}
    assert ctx.byte_stats() == {world: {"put": moved}}
    retries = alloc.stats["retried_page_puts"]
    assert retries == 3
    assert ctx.retry_stats() == {world: {"put": retries}}
    assert ctx.retry_byte_stats() == {world: {"put": retries
                                              * alloc.page_bytes}}
    assert ctx.rma.retry_bytes == retries * alloc.page_bytes
    assert plan.unrecovered() == []
    # the reference's allocator and communicator: the same books
    jmesh = make_mesh((4,), ("x",), axis_types="auto")
    jctx = JContext(mesh=jmesh, segment_bytes=1 << 20,
                    fault_plan=JFaultPlan(0))
    jplan = JFaultPlan(0, specs=tuple(JFaultSpec(*s) for s in specs))
    jalloc, _, jmoved = _migrate(JAlloc, JGlobalMemory, J_RING, jctx, jplan,
                                 J_FAST)
    assert moved == jmoved and alloc.stats == jalloc.stats
    assert alloc.call_log == jalloc.call_log
    assert ctx.stats() == jctx.stats()
    assert ctx.retry_stats() == jctx.retry_stats()
    assert ctx.retry_byte_stats() == jctx.retry_byte_stats()
    assert _stream(plan) == _stream(jplan)


# ---------------------------------------------------------------------------
# only first passes inject
# ---------------------------------------------------------------------------

def test_scratch_context_is_inert_under_ambient_chaos(monkeypatch):
    monkeypatch.setenv("DIOMP_CHAOS_SEED", "3")
    monkeypatch.setenv("DIOMP_CHAOS_P", "0.9")
    mesh = RankMesh(("x",), (3,))
    ctx = DiompContext(mesh=mesh, device="cpu",
                       retry_policy=RetryPolicy(max_retries=64, sleep=False))
    assert ctx.fault_plan is not None and ctx.fault_plan.p == 0.9
    scratch = scratch_context(ctx)
    assert scratch.fault_plan is not None and scratch.fault_plan.p == 0.0
    x = torch.ones(3, 2)
    with use_default(ctx):
        for i in range(3):
            with recorded_once(i == 0) as c:
                c.communicator(T_RING).allreduce(x)
    assert scratch.fault_plan.injected == [] and scratch.retry_stats() == {}
    # the first pass alone rolled the ambient plan, and recovered
    _recovered(ctx, ctx.fault_plan)
    assert ctx.stats() == {T_RING.descriptor(): {"allreduce": 1}}
