"""The port's serving engine held against the JAX package's.

Both engines serve reduced ``stablelm-3b`` on the 8-rank smoke mesh with the
same weights (carried in float32, so that greedy argmaxes do not hang on
bf16 rounding done at other places in the two frameworks), the same prompts
and, under an SLO policy, the same ``ManualClock`` schedule.  Greedy
tokens, per-request step counts, ``kv_stats``, the SLO decision log and the
migration byte logs must be equal — no float tolerance is involved.  The
communicator call log counts each built step's collectives once, as the
reference's logs count one trace of each step.  The allocator-only cases
run the same operations on both packages' allocators and compare their
tables; the pure-Python layers (traces, percentiles, breakers, retries)
must replay the reference exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as j_configs
from repro.core import resilience as j_res
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.core.pgas import GlobalMemory as JMemory
from repro.core.rma import RMATracker as JTracker
from repro.models import api as j_api
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.serve import slo as j_slo
from repro.serve import step as j_step
from repro.serve import trace as j_trace
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kvcache import PagedKVAllocator as JAlloc

from repro_torch import configs
from repro_torch.core import resilience
from repro_torch.core.context import DiompContext
from repro_torch.core.groups import DiompGroup
from repro_torch.core.pgas import GlobalMemory
from repro_torch.core.rma import RMATracker
from repro_torch.interop import params_from_reference
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import slo, trace
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import PagedKVAllocator

ARCH = "stablelm-3b"
CFG, JCFG = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
MESH = make_smoke_mesh(8)
PAGE_TOKENS = 16


@pytest.fixture(scope="module")
def weights():
    jp = {k: v.astype(jnp.float32) for k, v in
          j_sch.init_params(JCFG, jax.random.PRNGKey(0)).items()}
    tp = params_from_reference(CFG, MESH, {k: np.array(v)
                                           for k, v in jp.items()},
                               dtype=torch.float32)
    return jp, tp


def _kv_bpt():
    return 2 * 2 * CFG.kv_heads * CFG.head_dim * CFG.num_layers


def _engines(mesh8, weights, *, segment=1 << 26, ballast=False, **kw):
    jp, tp = weights
    jdc = JContext(mesh=mesh8, segment_bytes=segment, allocator="buddy")
    tdc = DiompContext(mesh=MESH, device="cpu", segment_bytes=segment,
                       allocator="buddy")
    j = JEngine(JCFG, mesh8, JCtx.from_mesh(mesh8, remat=False,
                                            inference=True),
                jp, context=jdc, **kw)
    t = ServeEngine(CFG, MESH, ParallelCtx.from_mesh(MESH, remat=False,
                                                     inference=True),
                    tp, context=tdc, **kw)
    if ballast:
        for eng in (j, t):
            sizes = [PAGE_TOKENS * _kv_bpt() if r == 0 else 0
                     for r in range(eng.memory.nranks)]
            eng.memory.alloc_asymmetric("ballast", sizes, eng._group)
    return j, t


def _prompts(lengths, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _serve(eng, lengths, max_new=4):
    reqs = [eng.submit(p, max_new=max_new) for p in _prompts(lengths)]
    eng.run()
    assert all(r.done and len(r.out) == max_new for r in reqs)
    return reqs


def _same_requests(jr, tr):
    for a, b in zip(jr, tr):
        assert b.out == a.out, (len(a.prompt), a.out, b.out)
        assert (b.prefill_steps, b.decode_steps, b.preemptions,
                b.admit_step, b.finish_step) == \
            (a.prefill_steps, a.decode_steps, a.preemptions, a.admit_step,
             a.finish_step)


# -- the engine -------------------------------------------------------------

LENGTHS = (3, 9, 17, 5, 26)


def test_engine_matches_reference(mesh8, weights):
    """Continuous batching with chunked prefill over mixed lengths."""
    j, t = _engines(mesh8, weights, slots=2, max_len=64, prefill_chunk=8)
    _same_requests(_serve(j, LENGTHS), _serve(t, LENGTHS))
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)
    assert t.kv_stats == j.kv_stats
    for r, n in zip(t._all, LENGTHS):
        assert r.prefill_steps == -(-n // 8)


def test_chunked_equals_token_by_token(mesh8, weights):
    """The port's chunked engine gives the token-by-token baseline's
    (prefill_chunk=1) greedy tokens, as the reference's does."""
    jp, tp = weights
    out = {}
    for chunk in (1, 8):
        eng = ServeEngine(
            CFG, MESH, ParallelCtx.from_mesh(MESH, remat=False,
                                             inference=True), tp,
            context=DiompContext(mesh=MESH, device="cpu",
                                 segment_bytes=1 << 26, allocator="buddy"),
            slots=2, max_len=64, prefill_chunk=chunk)
        out[chunk] = [r.out for r in _serve(eng, LENGTHS)]
    assert out[1] == out[8]


def test_preemption_and_migration_match_reference(mesh8, weights):
    """A hard KV OOM preempts, swaps pages to a spill heap over RMA and
    resumes: tokens, allocator stats and migration bytes as the
    reference's, and the bytes equal the OMPCCL and RMA logs."""
    j, t = _engines(mesh8, weights, segment=8 * PAGE_TOKENS * _kv_bpt(),
                    ballast=True, slots=2, max_len=64, prefill_chunk=8,
                    page_tokens=PAGE_TOKENS, high_watermark=10.0)
    _same_requests(_serve(j, (20, 21), 42), _serve(t, (20, 21), 42))
    assert sum(r.preemptions for r in t._all) >= 1
    assert t.kv_stats == j.kv_stats
    assert t.alloc.call_log == j.alloc.call_log
    moved = t.alloc.stats["bytes_migrated"]
    world = t._group.descriptor()
    assert moved > 0 and world == j._group.descriptor()
    assert t.dctx.byte_stats()[world]["put"] == moved
    assert t.dctx.rma.put_bytes == moved == j.dctx.rma.put_bytes
    assert t.dctx.stats()[world] == j.dctx.stats()[world]


def test_watermark_preemption_matches_reference(mesh8, weights):
    kw = dict(slots=3, max_len=64, prefill_chunk=8, high_watermark=1e-4,
              low_watermark=5e-5)
    j, t = _engines(mesh8, weights, **kw)
    _same_requests(_serve(j, (9, 14, 5), 6), _serve(t, (9, 14, 5), 6))
    assert sum(r.preemptions for r in t._all) >= 1
    assert t.kv_stats == j.kv_stats


def test_sampling_matches_reference(mesh8, weights):
    """Seeded top-k sampling draws the same tokens (the logits agree to
    float32 rounding; the draws are numpy's, from the same seed)."""
    j, t = _engines(mesh8, weights, slots=2, max_len=64, prefill_chunk=8,
                    temperature=0.9, top_k=8, seed=11)
    _same_requests(_serve(j, (7, 12), 6), _serve(t, (7, 12), 6))


def _drive(eng, clk):
    """The reference's seeded overload scenario (tests/test_overload.py:363)
    on either package."""
    pending = list(j_trace.bursty_trace(21, 10, max_prompt=12,
                                        max_new_choices=(2, 4),
                                        burst_rate_per_s=8.0))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, CFG.vocab_size, t.prompt_len).astype(np.int32)
               for t in pending]
    for _ in range(60):
        while pending and pending[0].arrival_s <= clk.now():
            t = pending.pop(0)
            eng.submit(prompts.pop(0), max_new=t.max_new,
                       priority=t.priority)
        eng.step()
        clk.advance(0.05)
        if not (pending or eng.active or eng.queue or eng.preempted):
            break
    return eng


def test_slo_decision_log_matches_reference(mesh8, weights):
    pol = dict(max_queue=6, queue_high=2, queue_low=1, min_step_s=0.01,
               degrade_sustain_steps=2, degrade_recover_steps=2,
               degraded_max_new=2)
    jclk, tclk = j_slo.ManualClock(), slo.ManualClock()
    j, t = _engines(mesh8, weights, slots=1, max_len=64, prefill_chunk=8)
    j = JEngine(JCFG, mesh8, j.ctx, j.params, context=j.dctx, slots=1,
                max_len=64, prefill_chunk=8, clock=jclk,
                slo=j_slo.SLOPolicy(default_tier=j_slo.TierPolicy(
                    ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    t = ServeEngine(CFG, MESH, t.ctx, t.params, context=t.dctx, slots=1,
                    max_len=64, prefill_chunk=8, clock=tclk,
                    slo=slo.SLOPolicy(default_tier=slo.TierPolicy(
                        ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    j, t = _drive(j, jclk), _drive(t, tclk)
    assert len(j.slo_log) > 0 and t.slo_log == j.slo_log
    assert t.shed == j.shed
    assert [r.out for r in t._all] == [r.out for r in j._all]
    drop = ("ttft_s", "request_s")          # the clocks are each engine's
    assert {k: v for k, v in t.latency_stats().items() if k not in drop} \
        == {k: v for k, v in j.latency_stats().items() if k not in drop}
    assert t.latency_stats()["ttft_s"] == pytest.approx(
        j.latency_stats()["ttft_s"])


def test_call_log_counts_each_built_step_once(mesh8, weights):
    """The port's engine logs its decode and chunk steps' collectives once
    each: the reference's logs for one trace of each step."""
    jp, _ = weights
    j, t = _engines(mesh8, weights, slots=2, max_len=64, prefill_chunk=8)
    _serve(t, LENGTHS)
    jctx = JCtx.from_mesh(mesh8, remat=False, inference=True)
    traced = JContext(mesh=mesh8)
    structs, _ = j_api.cache_structs(JCFG, mesh8, jctx, 2, 64)
    cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in structs.items()}
    cache["pos"] = jnp.zeros((2,), jnp.int32)
    structs1, _ = j_api.cache_structs(JCFG, mesh8, jctx, 1, 64)
    cache1 = {k: jnp.zeros(s.shape, s.dtype) for k, s in structs1.items()}
    with j_use_default(traced):
        jax.eval_shape(j_step.build_decode_step(
            JCFG, mesh8, jctx, B=2, S=64, donate=False, slot_pos=True),
            jp, np.zeros((2, 1), np.int32), cache)
        jax.eval_shape(j_step.build_chunk_prefill_step(
            JCFG, mesh8, jctx, C=8, S_cache=64), jp,
            np.zeros((1, 8), np.int32), cache1, jnp.asarray(8, jnp.int32))
    world = t._group.descriptor()
    mine = {k: v for k, v in t.dctx.stats().items() if k != world}
    assert mine == traced.stats() and mine
    assert {k: v for k, v in t.dctx.byte_stats().items() if k != world} \
        == traced.byte_stats()


def test_rank_death_waits_for_fault_injection(mesh8, weights):
    """(Kept name: rank death raised before fault injection was ported.)
    A graceful death of the rank homing the requests' pages, mid-decode:
    both engines drain it over the migrate path and finish with equal
    tokens, logs and page ledgers."""
    j, t = _engines(mesh8, weights, slots=2, max_len=64, prefill_chunk=8)
    jr = [j.submit(p, max_new=4) for p in _prompts(LENGTHS[:3])]
    tr = [t.submit(p, max_new=4) for p in _prompts(LENGTHS[:3])]
    for _ in range(4):
        j.step()
        t.step()
    for eng in (j, t):
        eng.on_rank_death(0, graceful=True)
    j.run()
    t.run()
    _same_requests(jr, tr)
    assert t.rank_death_log == j.rank_death_log
    (_, rank, graceful, drained, lost), = t.rank_death_log
    assert rank == 0 and graceful and drained > 0 and lost == 0
    assert t.kv_stats == j.kv_stats and t.kv_stats["pages_lost"] == 0
    assert t.alloc.call_log == j.alloc.call_log
    assert t.alloc.stats["bytes_migrated"] \
        == j.alloc.stats["bytes_migrated"] > 0


# -- the paged allocator against the reference's tables ----------------------

def _alloc_pair(page_tokens=16, nranks=4, segment=1 << 22):
    j = JAlloc(JMemory(nranks, segment, allocator="buddy"),
               JGroup(("x",), name="x"), page_tokens=page_tokens,
               kv_bytes_per_token=64)
    t = PagedKVAllocator(GlobalMemory(nranks, segment, allocator="buddy"),
                         DiompGroup(("x",), name="x"),
                         page_tokens=page_tokens, kv_bytes_per_token=64)
    return j, t


def _extend(a):
    r = a.admit(10, 200)
    for _ in range(100):
        r.pos += 1
        assert a.extend(r)
    a.release(r)


def _churn(a):
    for _ in range(26):
        r = a.admit(20, 60)
        for _ in range(40):
            r.pos += 1
            assert a.extend(r)
        a.release(r)
    a.trim()


def _lookup(a):
    r = a.admit(40, 80, home_rank=2)
    out = [a.lookup(r, p) for p in (0, 15, 16, 20, 21, 22, 39)]
    a.release(r)
    return out, a.memory.ptr_cache.hits


def _migrate(a):
    r = a.admit(30, 60, home_rank=0)

    class _Rec:
        def __init__(self):
            self.calls, self.nbytes = {}, {}

        def record(self, op, payload=None):
            self.calls[op] = self.calls.get(op, 0) + 1
            if payload is not None:
                self.nbytes[op] = self.nbytes.get(op, 0) + payload.nbytes

    comm = _Rec()
    tr = JTracker() if isinstance(a, JAlloc) else RMATracker()
    tr.register("w")
    moved = a.migrate(r, 3, comm=comm, tracker=tr, window="w")
    table = [a.memory.translate(p, 3) for p in r.page_table]
    a.release(r)
    return moved, comm.calls, comm.nbytes, tr.put_bytes, tr.fences, table


@pytest.mark.parametrize("case", [_extend, _churn, _lookup, _migrate],
                         ids=["extend", "free_list_reuse", "lookup",
                              "migrate"])
def test_allocator_matches_reference(case):
    j, t = _alloc_pair()
    assert case(t) == case(j)
    assert t.call_log == j.call_log
    assert t.stats == j.stats
    assert t.memory.alloc_counts == j.memory.alloc_counts
    assert t.memory.mapping_table() == j.memory.mapping_table()
    assert t.memory.bytes_in_use(0) == j.memory.bytes_in_use(0)


# -- pure-Python layers ----------------------------------------------------

def test_traces_and_percentiles_replay_the_reference():
    for seed, n in ((0, 50), (21, 10), (7, 200)):
        assert [tuple(r.__dict__.values()) for r in
                trace.bursty_trace(seed, n)] == \
            [tuple(r.__dict__.values()) for r in j_trace.bursty_trace(seed, n)]
    xs = list(np.random.RandomState(0).rand(37))
    assert slo.percentiles(xs) == j_slo.percentiles(xs)
    assert slo.percentile([], 50) is None


def test_resilience_replays_the_reference():
    assert [resilience.derive_rng("a", 1).random() for _ in range(3)] == \
        [j_res.derive_rng("a", 1).random() for _ in range(3)]
    pol, jpol = resilience.RetryPolicy(seed=3), j_res.RetryPolicy(seed=3)
    assert [pol.backoff_s("put", k) for k in range(1, 6)] == \
        [jpol.backoff_s("put", k) for k in range(1, 6)]
    digest = resilience.content_digest(b"page")
    assert digest == j_res.content_digest(b"page")
    assert resilience.corrupt_digest(digest, 4) == \
        j_res.corrupt_digest(digest, 4)
    logs = []
    for mod, clk in ((resilience, slo.ManualClock()),
                     (j_res, j_slo.ManualClock())):
        br = mod.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                                clock=clk)
        seq = [br.allow("k"), br.record_failure("k"), br.record_failure("k"),
               br.allow("k")]
        clk.advance(1.5)
        seq += [br.allow("k"), br.record_success("k", retries=2),
                br.allow("k")]
        logs.append((seq, br.transitions, br.stats, br.snapshot()))
    assert logs[0] == logs[1]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise resilience.TransientFault("drop")
        return "ok"

    assert resilience.call_with_retries(
        flaky, "put", resilience.RetryPolicy(sleep=False)) == "ok"
    assert len(calls) == 3


# -- MoE: reduced qwen3-moe through the dropless fused dispatch -------------

MOE = "qwen3-moe-235b-a22b"
MOE_CFG, MOE_JCFG = configs.get_reduced(MOE), j_configs.get_reduced(MOE)


@pytest.fixture(scope="module")
def moe_weights():
    jp = {k: v.astype(jnp.float32) for k, v in
          j_sch.init_params(MOE_JCFG, jax.random.PRNGKey(0)).items()}
    tp = params_from_reference(MOE_CFG, MESH, {k: np.array(v)
                                               for k, v in jp.items()},
                               dtype=torch.float32)
    return jp, tp


def _moe_engines(mesh8, moe_weights, **kw):
    """Both engines on reduced qwen3-moe under dispatch_impl="fused"."""
    jp, tp = moe_weights
    jdc = JContext(mesh=mesh8, segment_bytes=1 << 26, allocator="buddy")
    tdc = DiompContext(mesh=MESH, device="cpu", segment_bytes=1 << 26,
                       allocator="buddy")
    j = JEngine(MOE_JCFG, mesh8, JCtx.from_mesh(
        mesh8, remat=False, inference=True, dispatch_impl="fused"), jp,
        context=jdc, **kw)
    t = ServeEngine(MOE_CFG, MESH, ParallelCtx.from_mesh(
        MESH, remat=False, inference=True, dispatch_impl="fused"), tp,
        context=tdc, **kw)
    return j, t


def test_moe_engine_matches_reference(mesh8, moe_weights):
    """Continuous batching with chunked prefill over mixed lengths: every
    MoE layer of every decode and chunk step runs the one-sided ring.  The
    port's engine logs each built step's collectives once, the puts of the
    ring included: one trace of each of the reference's steps."""
    jp, _ = moe_weights
    j, t = _moe_engines(mesh8, moe_weights, slots=2, max_len=64,
                        prefill_chunk=8)
    _same_requests(_serve(j, LENGTHS), _serve(t, LENGTHS))
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)
    assert t.kv_stats == j.kv_stats
    jctx = JCtx.from_mesh(mesh8, remat=False, inference=True,
                          dispatch_impl="fused")
    traced = JContext(mesh=mesh8)
    structs, _ = j_api.cache_structs(MOE_JCFG, mesh8, jctx, 2, 64)
    cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in structs.items()}
    cache["pos"] = jnp.zeros((2,), jnp.int32)
    structs1, _ = j_api.cache_structs(MOE_JCFG, mesh8, jctx, 1, 64)
    cache1 = {k: jnp.zeros(s.shape, s.dtype) for k, s in structs1.items()}
    with j_use_default(traced):
        jax.eval_shape(j_step.build_decode_step(
            MOE_JCFG, mesh8, jctx, B=2, S=64, donate=False, slot_pos=True),
            jp, np.zeros((2, 1), np.int32), cache)
        jax.eval_shape(j_step.build_chunk_prefill_step(
            MOE_JCFG, mesh8, jctx, C=8, S_cache=64), jp,
            np.zeros((1, 8), np.int32), cache1, jnp.asarray(8, jnp.int32))
    world = t._group.descriptor()
    mine = {k: v for k, v in t.dctx.stats().items() if k != world}
    assert mine == traced.stats()
    assert {k: v for k, v in t.dctx.byte_stats().items() if k != world} \
        == traced.byte_stats()
    ep = DiompGroup(("model",), name="ep").descriptor()
    assert mine[ep]["put"] == 2 * 2      # (ep - 1) out and back, 2 steps


def test_moe_slo_decision_log_matches_reference(mesh8, moe_weights):
    pol = dict(max_queue=6, queue_high=2, queue_low=1, min_step_s=0.01,
               degrade_sustain_steps=2, degrade_recover_steps=2,
               degraded_max_new=2)
    jclk, tclk = j_slo.ManualClock(), slo.ManualClock()
    j, _ = _moe_engines(
        mesh8, moe_weights, slots=1, max_len=64, prefill_chunk=8, clock=jclk,
        slo=j_slo.SLOPolicy(default_tier=j_slo.TierPolicy(
            ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    _, t = _moe_engines(
        mesh8, moe_weights, slots=1, max_len=64, prefill_chunk=8, clock=tclk,
        slo=slo.SLOPolicy(default_tier=slo.TierPolicy(
            ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    j, t = _drive(j, jclk), _drive(t, tclk)
    assert len(j.slo_log) > 0 and t.slo_log == j.slo_log
    assert t.shed == j.shed
    assert [r.out for r in t._all] == [r.out for r in j._all]
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)
