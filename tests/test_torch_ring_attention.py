"""The port's ring attention held against the JAX package's.

The same inputs, made from a seed with numpy, go through both packages on
the CPU: the reference's single-device ``ring_attention_ref`` and its
``ring_attention`` under ``repro.core.compat.shard_map`` (its forward
emulation; the reference's gradient tests and the tests that pass
``check_rep`` do not run on jax 0.9), the port on stacked ranks, where the
kernel wrapper runs its plain version (the ``ompx_put`` emulation).

* The planner: ``AttentionRingPlan``'s schedule, sources, folds, causal
  skips, put counts, bytes and flops record for record, and
  ``plan_ring_attention`` equal to the reference's at its test sizes; at
  full width the port budgets the slots in device memory.
* The monoid: the masked-empty state is the bitwise identity of the merge.
* Values: the port within 1e-5 of |out|max of the reference in float32
  (both sum in f32, in another order), and within one bf16 ulp of each
  value in bfloat16 (the f32 states round to bf16 at the end).
* The port's three executions — fused order, serialized host listing and
  ``ring_attention_ref`` — equal bit for bit (``==``).
* The put books: calls, bytes and tracker windows equal to the plan's and
  to the reference's logs.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.core.rma import attention_window_names as j_window_names
from repro.kernels import plan as j_plan
from repro.kernels.ring_attention import ring_attention as j_ring_attention
from repro.kernels.ring_attention import ring_attention_ref as j_ring_ref

from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.core.rma import attention_window_names
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels import plan
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ring_attention import (empty_state, merge_states,
                                                resolve_attention_impl,
                                                ring_attention,
                                                ring_attention_ref,
                                                scaled_queries, stripe_mask,
                                                stripe_state)
from repro_torch.kernels.ring_attention.fused import (
    _ring_slots, fused_ring_attention_interpret, fused_ring_attention_kernel)
from repro_torch.launch.mesh import RankMesh

GROUP, JGROUP = DiompGroup(("x",), name="x"), JGroup(("x",), name="x")
SEQ = (None, "x", None, None)         # (B, T, heads, dim), T over the ring
REPL = (None, None, None, None)


# -- the planner ---------------------------------------------------------------

PLAN_FIELDS = ("n", "tq_loc", "tk_loc", "h", "kh", "d", "dv", "b", "itemsize",
               "causal", "q_sharded", "q_offset", "valid_len", "direction",
               "slots", "overlap")


def _same_records(mine, ref):
    assert mine.schedule() == tuple(
        plan.RingStep(**dataclasses.asdict(st)) for st in ref.schedule())
    assert mine.fold_steps() == ref.fold_steps()
    assert mine.exchange_steps == ref.exchange_steps
    for prop in ("stripe_bytes", "puts_per_rank", "wire_bytes",
                 "stripe_flops"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    for r in range(mine.n):
        assert mine.sources(r) == ref.sources(r)
        assert mine.computed_sources(r) == ref.computed_sources(r)
        assert mine.flops(r) == ref.flops(r)
        assert [mine.computes(r, s) for s in range(mine.n)] == \
            [ref.computes(r, s) for s in range(ref.n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("direction", ["bidi", "cw", "ccw"])
@pytest.mark.parametrize("layout", ["train", "chunk", "traced", "padded"])
def test_plan_records_equal_reference(n, direction, layout):
    kw = dict(n=n, tq_loc=4, tk_loc=6, h=4, kh=2, d=8, dv=4, b=2,
              direction=direction)
    kw.update({"train": dict(causal=True),
               "chunk": dict(q_sharded=False, q_offset=6 * n - 5),
               "traced": dict(q_sharded=False, q_offset=None),
               "padded": dict(causal=False, valid_len=6 * n - 7)}[layout])
    _same_records(plan.AttentionRingPlan(**kw), j_plan.AttentionRingPlan(**kw))


PLANNER_CASES = {
    "n4_causal": ((2, 4, 4, 4, 2, 8, 8), 4, {}),
    "n4_host": ((2, 4, 4, 4, 2, 8, 8), 4, dict(overlap=False)),
    "n2_chunk": ((2, 8, 8, 4, 2, 8, 8), 2,
                 dict(q_sharded=False, q_offset=None)),
    "n8_padded": ((2, 2, 3, 4, 1, 8, 4), 8, dict(valid_len=20)),
    "n1": ((1, 16, 16, 8, 1, 8, 8), 1, {}),
    "n3_cw": ((1, 4, 4, 4, 4, 8, 8), 3, dict(direction="cw")),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_plan_ring_attention_equals_reference(case):
    args, n, kw = PLANNER_CASES[case]
    mine = plan.OverlapPlanner().plan_ring_attention(*args, torch.float32, n,
                                                     **kw)
    ref = j_plan.OverlapPlanner().plan_ring_attention(*args, jnp.float32, n,
                                                      **kw)
    for f in PLAN_FIELDS:
        assert getattr(mine, f) == getattr(ref, f), f
    _same_records(mine, ref)


@pytest.mark.parametrize("shape", ["served_chunk", "seq_parallel"])
def test_full_width_plan_budgets_device_memory(shape):
    """paligemma's head layout (8 heads on 1 kv head, head_dim 256, bf16).
    The served chunk: 512 shared queries over a 4096-row cache on 2 ranks;
    the sequence-parallel shape: 4 ranks of 4096 rows.  The port's slots
    live in device memory and are budgeted against the n stripes of the
    all-gathered K/V; the reference's 16 MiB VMEM budget, net of its
    resident f32 queries and carry, grants the seq-parallel ring the
    double-buffered minimum only.  Both key tiles fit shared memory."""
    args, n, kw = {
        "served_chunk": ((1, 512, 2048, 8, 1, 256, 256), 2,
                         dict(q_sharded=False, q_offset=None)),
        "seq_parallel": ((1, 4096, 4096, 8, 1, 256, 256), 4, {}),
    }[shape]
    mine = plan.OverlapPlanner().plan_ring_attention(*args, torch.bfloat16,
                                                     n, **kw)
    ref = j_plan.OverlapPlanner().plan_ring_attention(*args, jnp.bfloat16,
                                                      n, **kw)
    assert mine.stripe_bytes == ref.stripe_bytes == args[2] * 512 * 2
    assert mine.block == 64
    assert plan.OverlapPlanner.flash_stage_bytes(256, 256, 64) \
        <= plan.SMEM_BUDGET_DEFAULT
    assert ref.slots == 2
    assert mine.slots == n
    assert _ring_slots(mine) == max(n, 2)
    assert mine.staging_bytes == 2 * n * mine.stripe_bytes \
        + args[1] * 8 * (2 + 256) * 4


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("direction", ["bidi", "cw", "ccw"])
def test_attention_window_names_equal_reference(n, direction):
    assert attention_window_names(GROUP, n, direction) == \
        j_window_names(JGROUP, n, direction)
    with pytest.raises(ValueError):
        attention_window_names(GROUP, n, "both")


# -- the monoid ------------------------------------------------------------------

def test_empty_state_is_the_exact_merge_identity():
    rng = np.random.RandomState(0)
    qg = scaled_queries(torch.tensor(rng.randn(2, 3, 4, 8), dtype=torch.float32),
                        2, 0.3)
    k = torch.tensor(rng.randn(2, 5, 2, 8), dtype=torch.float32)
    v = torch.tensor(rng.randn(2, 5, 2, 6), dtype=torch.float32)
    vis = stripe_mask(5, q_pos=torch.arange(3)[None] + 2, k_start=0,
                      causal=True)
    state = stripe_state(qg, k, v, vis.expand(2, 3, 5))
    state[2][0, 0, 0, 0, 0] = -0.0
    empty = empty_state(qg, 6)
    for merged in (merge_states(state, empty), merge_states(empty, state)):
        for a, b in zip(merged, state):
            assert torch.equal(a, b)
            assert torch.equal(torch.signbit(a), torch.signbit(b))
    # a fully masked stripe gives exactly the empty state
    none = torch.zeros(2, 3, 5, dtype=torch.bool)
    for a, b in zip(stripe_state(qg, k, v, none), empty):
        assert torch.equal(a, b)


# -- values against the reference ----------------------------------------------

def _case(n, *, tq=4, H=4, KH=2, D=8, DV=8, B=2, seed=0):
    rng = np.random.RandomState(seed)
    T = n * tq
    return (rng.randn(B, T, H, D).astype(np.float32),
            rng.randn(B, T, KH, D).astype(np.float32),
            rng.randn(B, T, KH, DV).astype(np.float32))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _close(got, want, bf16):
    """f32: 1e-5 of |want|max; bf16: one bf16 ulp of each value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if bf16:
        mag = np.maximum(np.abs(got), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _t(a, bf16):
    return torch.tensor(a, dtype=torch.bfloat16 if bf16 else torch.float32)


def _j(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


CASES = {
    # name: (n, case kwargs, call kwargs, bf16)
    "n2_causal": (2, {}, {}, False),
    "n4_bidi": (4, {}, dict(causal=False), False),
    "n4_bf16": (4, {}, {}, True),
    "n4_mqa": (4, dict(KH=1), {}, False),
    "n4_mha": (4, dict(KH=4), {}, False),
    "n4_dv_ne_d": (4, dict(DV=4), {}, False),
    "n1": (1, {}, {}, False),
    "n3_gqa8": (3, dict(H=8, KH=1), {}, False),
    "n8_causal": (8, dict(tq=2), {}, False),
    "n4_padded": (4, dict(tq=6), dict(valid_len=20), False),
    "n3_padded_bf16": (3, dict(H=8, KH=1), dict(valid_len=10), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_reference_ref(name):
    n, ckw, kw, bf16 = CASES[name]
    q, k, v = (_bf16(a) if bf16 else a for a in _case(n, **ckw))
    want = np.asarray(j_ring_ref(*(_j(a, bf16) for a in (q, k, v)), n=n,
                                 **kw), np.float32)
    got = ring_attention_ref(*(_t(a, bf16) for a in (q, k, v)), n=n, **kw)
    _close(got.float().numpy(), want, bf16)
    # and the ring tracks flash attention to float tolerance
    if not bf16 and "valid_len" not in kw:
        fl = flash_attention_ref(*map(torch.tensor, (q, k, v)),
                                 causal=kw.get("causal", True)).numpy()
        assert np.abs(got.numpy() - fl).max() <= 1e-5 * np.abs(fl).max()


def _port_ring(q, k, v, n, *, spec=SEQ, mesh=None, dc=None, **kw):
    mesh = mesh or RankMesh(("x",), (n,))
    dc = dc or DiompContext(mesh=mesh, device="cpu")
    with use_default(dc):
        out = ring_attention(stack_shards(q, mesh, spec),
                             *(stack_shards(a, mesh, SEQ) for a in (k, v)),
                             GROUP, **kw)
    return out, mesh


def _ref_shard_map(q, k, v, n, **kw):
    """The reference's ring (its forward emulation) under shard_map on the
    8-device CPU mesh's first n devices; no ``check_rep``."""
    mesh = make_mesh((n,), ("x",), axis_types="auto")

    def f(q, k, v):
        return j_ring_attention(q, k, v, JGROUP, **kw)

    spec = P(None, "x")
    return np.asarray(jax.jit(shard_map(f, mesh=mesh, in_specs=(spec,) * 3,
                                        out_specs=spec))(q, k, v), np.float32)


@pytest.mark.parametrize("impl", ["host", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_reference_shard_map(name, impl):
    n, ckw, kw, bf16 = CASES[name]
    q, k, v = (_bf16(a) if bf16 else a for a in _case(n, **ckw))
    want = _ref_shard_map(*(_j(a, bf16) for a in (q, k, v)), n, impl=impl,
                          **kw)
    out, mesh = _port_ring(*(_t(a, bf16) for a in (q, k, v)), n, impl=impl,
                           **kw)
    _close(unstack_shards(out, mesh, SEQ), want, bf16)


def _chunk_case(n, *, tq=8, p0=9, B=2, H=4, KH=2, D=8, seed=7):
    rng = np.random.RandomState(seed)
    S = n * 6                             # cached rows striped over n ranks
    return (rng.randn(B, tq, H, D).astype(np.float32),
            rng.randn(B, S, KH, D).astype(np.float32),
            rng.randn(B, S, KH, D).astype(np.float32), p0, tq)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("offsets", ["int", "tensor"])
def test_chunked_prefill_layout_matches_reference(n, offsets):
    """Replicated queries (``q_sharded=False``), K/V striped, offsets as
    ints or as per-rank tensors: the engine's chunked-prefill layout.  The
    reference runs its shard_map'd ring with traced offsets; its output is
    returned once a rank (identical on every rank)."""
    q, k, v, p0, tq = _chunk_case(n)
    mesh = make_mesh((n,), ("x",), axis_types="auto")

    def f(q, k, v, off):
        out = j_ring_attention(q, k, v, JGROUP, causal=True, q_offset=off[0],
                               valid_len=off[0] + tq, q_sharded=False)
        return out[None]

    want = np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(), P(None, "x"), P(None, "x"), P()),
        out_specs=P("x")))(q, k, v, jnp.asarray([p0], jnp.int32)))
    oracle = np.asarray(j_ring_ref(q, k, v, n=n, causal=True, q_offset=p0,
                                   valid_len=p0 + tq, q_sharded=False))
    off = p0 if offsets == "int" else \
        torch.full((n, 1), p0, dtype=torch.int32)
    out, _ = _port_ring(q, k, v, n, spec=REPL, causal=True, q_offset=off,
                        valid_len=off + tq, q_sharded=False)
    for r in range(n):
        _close(out[r].numpy(), want[r], False)
        _close(out[r].numpy(), oracle, False)
    # per-row offsets: each batch row its own chunk position.  Every rank
    # folds the same stripes in its own schedule order, so rank 0 gives the
    # plain version's bits (it replays rank 0's order) and the others agree
    # to rounding
    rows = torch.tensor([[p0, p0 - 3]] * n, dtype=torch.int32)
    out, _ = _port_ring(q, k, v, n, spec=REPL, causal=True, q_offset=rows,
                        valid_len=rows + tq, q_sharded=False)
    for b in range(2):
        want_b = ring_attention_ref(
            *(torch.tensor(a[b:b + 1]) for a in (q, k, v)), n=n, causal=True,
            q_offset=int(rows[0, b]), valid_len=int(rows[0, b]) + tq,
            q_sharded=False)
        assert torch.equal(out[0, b:b + 1], want_b)
        for r in range(1, n):
            _close(out[r, b:b + 1].numpy(), want_b.numpy(), False)


# -- the port's three executions, bit for bit ---------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_host_ref_bit_equal(name):
    n, ckw, kw, bf16 = CASES[name]
    q, k, v = (_t(_bf16(a) if bf16 else a, bf16) for a in _case(n, **ckw))
    want = ring_attention_ref(q, k, v, n=n, **kw)
    for impl in ("host", "fused"):
        out, mesh = _port_ring(q, k, v, n, impl=impl, **kw)
        got = unstack_shards(out, mesh, SEQ)
        assert np.array_equal(got, want.float().numpy()), impl


def test_bit_equal_on_a_two_axis_mesh():
    """The ring is one axis of a (data 2, x 3) mesh: each data row is an
    independent ring, and each equals the plain version bit for bit."""
    n, B = 3, 2
    q, k, v = (torch.tensor(a) for a in _case(n, B=2 * B, H=8, KH=1, seed=4))
    mesh = RankMesh(("data", "x"), (2, n))
    spec = ("data", "x", None, None)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        out = ring_attention(*(stack_shards(a, mesh, spec) for a in (q, k, v)),
                             GROUP, causal=True)
    got = torch.tensor(unstack_shards(out, mesh, spec))
    for d in range(2):
        rows = slice(d * B, (d + 1) * B)
        assert torch.equal(got[rows], ring_attention_ref(
            q[rows], k[rows], v[rows], n=n))


def test_kernel_wrapper_on_cpu_is_the_emulation():
    n = 4
    q, k, v = (torch.tensor(a) for a in _case(n, seed=2))
    mesh = RankMesh(("x",), (n,))
    p = plan.OverlapPlanner().plan_ring_attention(2, 4, 4, 4, 2, 8, 8,
                                                  torch.float32, n)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        args = [stack_shards(a, mesh, SEQ) for a in (q, k, v)]
        before = fused_ring_attention_kernel.launches
        got = fused_ring_attention_kernel(*args, GROUP, plan=p)
        emu = fused_ring_attention_interpret(*args, GROUP, plan=p)
    assert fused_ring_attention_kernel.launches == before
    assert torch.equal(got, emu)


# -- the put books ---------------------------------------------------------------

@pytest.mark.parametrize("impl", ["host", "fused"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_put_logs_equal_plan_and_reference(impl, n):
    q, k, v = _case(n)
    B, T, H, D = q.shape
    p = plan.OverlapPlanner().plan_ring_attention(
        B, T // n, T // n, H, k.shape[2], D, v.shape[-1], torch.float32, n,
        overlap=impl == "fused")
    jdc = JContext()
    with j_use_default(jdc):
        mesh = make_mesh((n,), ("x",), axis_types="auto")
        jax.jit(shard_map(
            lambda q, k, v: j_ring_attention(q, k, v, JGROUP, impl=impl),
            mesh=mesh, in_specs=(P(None, "x"),) * 3,
            out_specs=P(None, "x"))).lower(q, k, v)
    dc = DiompContext(mesh=RankMesh(("x",), (n,)), device="cpu")
    _port_ring(q, k, v, n, dc=dc, impl=impl)
    desc = GROUP.descriptor()
    assert desc == JGROUP.descriptor()
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    assert dc.stats()[desc]["put"] == p.puts_per_rank == 2 * (n - 1)
    cw_w, ccw_w = attention_window_names(GROUP, n)
    assert dc.rma.window_bytes == jdc.rma.window_bytes
    assert dc.byte_stats()[desc]["put"] == p.wire_bytes == \
        sum(dc.rma.window_bytes[w] for w in cw_w + ccw_w) == dc.rma.put_bytes


# -- API contracts -----------------------------------------------------------------

def test_resolvers_and_flash_ring_route():
    assert resolve_attention_impl(None) == "fused"
    assert resolve_attention_impl("auto") == "fused"
    assert resolve_attention_impl("host") == "host"
    with pytest.raises(ValueError, match="ring attention impl"):
        resolve_attention_impl("bogus")
    q, k, v = (torch.tensor(a) for a in _case(2))
    with pytest.raises(ValueError, match="DiompGroup"):
        flash_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention(q, k, v, impl="ring", group=GROUP, prefix_len=4)
    mesh = RankMesh(("x",), (2,))
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        args = [stack_shards(a.numpy(), mesh, SEQ) for a in (q, k, v)]
        got = flash_attention(*args, impl="ring", group=GROUP)
    assert torch.equal(torch.tensor(unstack_shards(got, mesh, SEQ)),
                       ring_attention_ref(q, k, v, n=2))


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_against_plain_on_the_card():
    """The CUDA kernel against its plain version: chip_smoke's
    ``check_ring_attention`` (ragged shapes, n 1-4, both layouts, f32 and
    bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.check_ring_attention(torch, chip_smoke.load_port(), gen)
