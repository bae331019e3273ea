"""Rank death in the port's serving engine and trainer, held against the
JAX package's (``tests/test_rank_death.py``, ``tests/test_overload.py``).

Both engines serve reduced ``stablelm-3b`` on the 8-rank smoke mesh with
the same weights (carried in float32, as ``test_torch_serve.py`` carries
them), the same prompts and the same ``FaultPlan`` schedule:

* graceful: the controller rank dies mid-decode, its pages drain over the
  validated ``migrate`` and every request completes with the undisturbed
  run's tokens;
* abrupt: the rank's pages are lost, active requests requeue and
  regenerate the undisturbed run's tokens, the page ledger balances;
* the scheduler's rank set shrinks, and the last live rank is protected;
* a spill rank whose migrations spend the retry budget is opened by the
  circuit breaker, migrations reroute, outputs stay correct.

For each, the port's ``rank_death_log``, ``kv_stats``, allocator call log,
SLO log and outputs must equal the reference engine's: no float tolerance
is involved.  The trainer's elastic restore (a death at a step, the mesh
halved, the run resumed from the checkpoint) is held against the port
launcher's own uninterrupted run within the reference test's 5e-2: the
reference's launcher does not run on this jax.
"""

import numpy as np
import pytest
import torch

from repro.core.context import DiompContext as JContext
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.core.resilience import CircuitBreaker as JBreaker
from repro.core.resilience import RetryPolicy as JRetryPolicy
from repro.models.config import ParallelCtx as JCtx
from repro.serve import slo as j_slo
from repro.serve.engine import ServeEngine as JEngine

from repro_torch.core.context import DiompContext
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.resilience import CircuitBreaker, RetryPolicy
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import slo
from repro_torch.serve.engine import ServeEngine

from test_torch_serve import CFG, JCFG, MESH, _prompts, weights  # noqa: F401

LENGTHS = (5, 9, 13)
MAX_NEW = 6


def _pair(mesh8, weights, jplan=None, tplan=None, jpolicy=None, tpolicy=None,
          jextra=(), textra=(), **kw):
    """The reference's and the port's engines on the same weights, each
    context carrying its package's plan (an inert one by default), each
    engine its package's ``*extra`` arguments (a clock, a breaker)."""
    jp, tp = weights
    jdc = JContext(mesh=mesh8, segment_bytes=1 << 26, allocator="buddy",
                   fault_plan=jplan or JFaultPlan(0, p=0.0),
                   retry_policy=jpolicy)
    tdc = DiompContext(mesh=MESH, device="cpu", segment_bytes=1 << 26,
                       allocator="buddy",
                       fault_plan=tplan or FaultPlan(0, p=0.0),
                       retry_policy=tpolicy)
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    j = JEngine(JCFG, mesh8, JCtx.from_mesh(mesh8, remat=False,
                                            inference=True),
                jp, context=jdc, **dict(jextra), **kw)
    t = ServeEngine(CFG, MESH, ParallelCtx.from_mesh(MESH, remat=False,
                                                     inference=True),
                    tp, context=tdc, **dict(textra), **kw)
    return j, t


def _submit(eng, lengths=LENGTHS, max_new=MAX_NEW):
    return [eng.submit(p, max_new=max_new) for p in _prompts(lengths)]


def _same(j, t, jr, tr):
    assert [r.out for r in tr] == [r.out for r in jr]
    assert t.rank_death_log == j.rank_death_log
    assert t.kv_stats == j.kv_stats
    assert t.alloc.call_log == j.alloc.call_log
    assert t.alloc.stats == j.alloc.stats
    keys = ("rank_deaths", "live_ranks", "requeued")
    assert {k: t.latency_stats()[k] for k in keys} \
        == {k: j.latency_stats()[k] for k in keys}


@pytest.fixture(scope="module")
def undisturbed(mesh8, weights):  # noqa: F811
    j, t = _pair(mesh8, weights)
    jr, tr = _submit(j), _submit(t)
    j.run()
    t.run()
    assert [r.out for r in tr] == [r.out for r in jr]
    return [r.out for r in tr]


def test_graceful_death_drains_pages_and_completes(mesh8, weights,  # noqa: F811
                                                    undisturbed):
    jplan = JFaultPlan(0, p=0.0).kill_rank(6, rank=0, graceful=True)
    tplan = FaultPlan(0, p=0.0).kill_rank(6, rank=0, graceful=True)
    j, t = _pair(mesh8, weights, jplan, tplan)
    jr, tr = _submit(j), _submit(t)
    j.run()
    t.run()
    assert all(r.done and len(r.out) == MAX_NEW for r in tr)
    assert [r.out for r in tr] == undisturbed
    _same(j, t, jr, tr)
    (step, rank, graceful, drained, lost), = t.rank_death_log
    assert step == 6 and rank == 0 and graceful
    assert drained > 0 and lost == 0
    kv = t.kv_stats
    assert kv["pages_allocated"] == kv["pages_freed"] > 0
    assert kv["pages_lost"] == 0
    assert tplan.deaths_at(6) == []
    # every page of the drain went through the validated migrate: the
    # plan rolled one "migrate" a transfer, the communicator counted one
    # get a page
    assert tplan._counters["migrate"] == jplan._counters["migrate"] \
        == t.dctx.stats()[t._group.descriptor()]["get"] > 0


def test_abrupt_death_requeues_and_reproduces_outputs(mesh8, weights,  # noqa: F811
                                                      undisturbed):
    j, t = _pair(mesh8, weights)
    jr, tr = _submit(j), _submit(t)
    for _ in range(5):
        j.step()
        t.step()
    homed = [r for r in t.active.values()
             if r.kv is not None and r.kv.home_rank == 0 and r.kv.page_table]
    assert homed
    j.on_rank_death(0, graceful=False)
    t.on_rank_death(0, graceful=False)
    j.run()
    t.run()
    assert all(r.done and len(r.out) == MAX_NEW for r in tr)
    assert [r.out for r in tr] == undisturbed
    _same(j, t, jr, tr)
    assert t.latency_stats()["requeued"] >= len(homed)
    assert t.latency_stats()["live_ranks"] == t.memory.nranks - 1
    kv = t.kv_stats
    assert kv["pages_lost"] > 0
    assert kv["pages_allocated"] == kv["pages_freed"]


def test_dead_rank_leaves_scheduling_rotation(mesh8, weights):  # noqa: F811
    j, t = _pair(mesh8, weights)
    n = t.memory.nranks
    for eng in (j, t):
        eng.on_rank_death(2)
    assert t._live_ranks() == j._live_ranks() == \
        [r for r in range(n) if r != 2]
    assert t._home(0) == j._home(0) == 0
    for eng in (j, t):
        eng.on_rank_death(0)
    assert t._home(0) == j._home(0) == 1
    for eng in (j, t):
        eng.on_rank_death(2)                   # idempotent: already dead
    assert t.latency_stats()["rank_deaths"] == 2 \
        == j.latency_stats()["rank_deaths"]
    assert t.alloc.dead_ranks == j.alloc.dead_ranks == {0, 2}
    assert t.alloc.call_log == j.alloc.call_log


def test_last_live_rank_is_protected(mesh8, weights):  # noqa: F811
    j, t = _pair(mesh8, weights)
    for eng in (j, t):
        for r in range(eng.memory.nranks - 1):
            eng.on_rank_death(r)
        with pytest.raises(RuntimeError, match="last live rank"):
            eng.on_rank_death(eng.memory.nranks - 1)
    assert t.rank_death_log == j.rank_death_log


def test_flaky_spill_rank_quarantined_and_recovers(mesh8, weights):  # noqa: F811
    """The reference's acceptance scenario (``tests/test_overload.py``): the
    first migrate put and its retry are corrupted; with a budget of one the
    first spill surfaces RMAError, the breaker opens on that rank, later
    migrations reroute, outputs stay correct and the ledger balances."""
    lengths, max_new = (9, 14, 5), 6
    kw = dict(slots=3, max_len=64, prefill_chunk=8)
    ref_j, ref_t = _pair(mesh8, weights, **kw)
    for eng in (ref_j, ref_t):
        _submit(eng, lengths, max_new)
        eng.run()
    jclk, tclk = j_slo.ManualClock(), slo.ManualClock()
    sides = []
    for plan_cls, spec_cls, pol_cls, brk_cls, clk in (
            (JFaultPlan, JFaultSpec, JRetryPolicy, JBreaker, jclk),
            (FaultPlan, FaultSpec, RetryPolicy, CircuitBreaker, tclk)):
        # the first migrate put AND its retry corrupted: the first spill
        # spends its whole budget; every later transfer is clean
        sides.append((plan_cls(0, specs=(spec_cls("migrate", 0, "corrupt"),
                                         spec_cls("migrate", 1, "corrupt"))),
                      pol_cls(per_verb={"migrate": 1}, sleep=False),
                      dict(clock=clk, breaker=brk_cls(
                          failure_threshold=1, cooldown_s=50.0,
                          half_open_probes=1, clock=clk))))
    (jplan, jpol, jextra), (tplan, tpol, textra) = sides
    j, t = _pair(mesh8, weights, jplan, tplan, jpol, tpol, jextra.items(),
                 textra.items(), high_watermark=1e-4, low_watermark=5e-5,
                 **kw)
    jcb, tcb = jextra["breaker"], textra["breaker"]
    runs = []
    for eng, clk in ((j, jclk), (t, tclk)):
        reqs = _submit(eng, lengths, max_new)
        while eng.active or eng.queue or eng.preempted:
            eng.step()
            clk.advance(0.01)
        runs.append(reqs)
    jr, tr = runs
    for a, b in zip(ref_t._all, tr):
        assert b.done and a.out == b.out
    assert [r.out for r in tr] == [r.out for r in jr]
    assert tcb.stats == jcb.stats and tcb.stats["opened"] == 1
    assert tcb.transitions == jcb.transitions
    assert t.slo_log == j.slo_log
    open_keys = [k for k in tcb.open_keys() if tcb.state(k) == "open"]
    assert len(open_keys) == 1 and open_keys[0][0] == "migrate"
    flaky = open_keys[0][1]
    assert any(e[0] == "breaker" and e[2] == flaky and e[4] == "open"
               for e in t.slo_log)
    assert t.alloc.stats == j.alloc.stats
    assert t.alloc.stats["migrations"] >= 1
    assert t.alloc.call_log == j.alloc.call_log
    assert flaky not in {e[3] for e in t.alloc.call_log if e[0] == "migrate"}
    assert t.kv_stats == j.kv_stats and t.kv_stats["live_pages"] == 0
    assert t.dctx.retry_stats() == j.dctx.retry_stats()


def test_engine_fault_stream_counts_first_traces(mesh8, weights,  # noqa: F811
                                                 monkeypatch):
    """The counting rule of the engine's fault stream.  The reference rolls
    its plan while it traces a jitted step, the port on the first call of
    a built step for each input signature (later calls replay against the
    scratch context's inert plan).  jax 0.9 traces the chunk step a second
    time once its cache is committed, and that retrace rolls the step's
    verbs again, shifting every later call index; the port does not
    retrace.  So, with the reference's retraces silenced (their verbs
    counted, not rolled), the two engines give equal tokens, the port's
    rolls of each first call equal the reference's of the matching first
    trace (the built step's verbs and their retries), and the two injected
    streams are equal; unsilenced, the reference's extra rolls are exactly
    the retraces' verbs."""
    import repro.models.api as japi
    import repro.models.transformer as jtr
    from repro_torch.serve import step as t_step

    jplan = JFaultPlan(7, p=0.3, kinds=("drop", "fail"))
    tplan = FaultPlan(7, p=0.3, kinds=("drop", "fail"))
    traces, calls, silenced, retracing = [], [], [], [False]
    seen = set()

    def traced(kind, fn):
        def body(params, tokens, *args, **kw):
            key = (kind, tuple(tokens.shape))
            retracing[0] = key in seen
            seen.add(key)
            before = dict(jplan._counters)
            try:
                out = fn(params, tokens, *args, **kw)
            finally:
                retracing[0] = False
            traces.append((kind, before, dict(jplan._counters)))
            return out
        return body

    rolled = jplan.next_fault

    def next_fault(verb):
        if retracing[0]:
            silenced.append(verb)
            return None
        return rolled(verb)

    jplan.next_fault = next_fault
    decode_fn = japi.decode_fn
    monkeypatch.setattr(japi, "decode_fn",
                        lambda cfg: traced("decode", decode_fn(cfg)))
    monkeypatch.setattr(jtr, "transformer_chunk_prefill",
                        traced("chunk", jtr.transformer_chunk_prefill))
    call = t_step.ServeStep.__call__

    def counted(self, *args):
        first = t_step._signature(args) not in self._seen
        before = dict(tplan._counters)
        out = call(self, *args)
        calls.append((self, first, before, dict(tplan._counters)))
        return out

    monkeypatch.setattr(t_step.ServeStep, "__call__", counted)
    j, t = _pair(mesh8, weights, jplan, tplan, JRetryPolicy(sleep=False),
                 RetryPolicy(sleep=False))
    jr, tr = _submit(j), _submit(t)
    j.run()
    t.run()
    assert [r.out for r in tr] == [r.out for r in jr]

    def delta(before, after):
        return {v: n - before.get(v, 0) for v, n in after.items()
                if n != before.get(v, 0)}

    kinds = {id(t.decode_step): "decode", id(t.chunk_step): "chunk"}
    t_first = [(kinds[id(s)], delta(b, a)) for s, f, b, a in calls if f]
    j_first = [(k, delta(b, a)) for k, b, a in traces if delta(b, a)]
    # one roll window a distinct signature, in the same order, the same
    # verbs and retries; later calls roll nothing
    assert t_first == j_first and len(t_first) == 2
    assert all(delta(b, a) == {} for _, f, b, a in calls if not f)
    assert tplan._counters == jplan._counters
    # the port's stream is the reference's over its first traces
    got = [(f.verb, f.call_index, f.kind) for f in tplan.injected]
    assert got == [(f.verb, f.call_index, f.kind) for f in jplan.injected]
    assert got and all(f.recovered for f in tplan.injected)
    # what the retrace would have rolled: the chunk step's verbs once more
    # (its first trace's rolls less one retry roll a fault)
    (kind, lo, hi), = [row for row in traces if row[0] == "chunk"][:1]
    faults = {}
    for f in jplan.injected:
        if lo.get(f.verb, 0) <= f.call_index < hi.get(f.verb, 0):
            faults[f.verb] = faults.get(f.verb, 0) + 1
    retraced = {}
    for v in silenced:
        retraced[v] = retraced.get(v, 0) + 1
    assert [k for k, _, _ in traces] == ["chunk", "chunk", "decode"]
    assert retraced == {v: n - faults.get(v, 0)
                        for v, n in delta(lo, hi).items()}


# ---------------------------------------------------------------------------
# training: death -> escalate -> checkpoint -> shrink -> restore
# ---------------------------------------------------------------------------

def test_elastic_restore_matches_uninterrupted_loss(tmp_path):
    from repro_torch.core.context import reset_default_context
    from repro_torch.launch.train import main
    common = ["--arch", "stablelm-3b", "--reduced", "--steps", "6",
              "--batch", "4", "--seq", "16", "--checkpoint-every", "2",
              "--device", "cpu"]
    try:
        want = main(common + ["--checkpoint-dir", str(tmp_path / "a")])
        got = main(common + ["--checkpoint-dir", str(tmp_path / "b"),
                             "--chaos-seed", "5", "--chaos-p", "0.0",
                             "--kill-rank-step", "3", "--max-restarts", "1"])
    finally:
        reset_default_context()
    assert want["restarts"] == 0 and got["restarts"] == 1
    assert want["mesh"].size == 8 and got["mesh"].size == 4
    # the restored run replays the same data from the checkpoint on the
    # shrunken mesh; only reduction order differs
    assert np.isclose(got["loss"], want["loss"], atol=5e-2), \
        (got["loss"], want["loss"])
    # the fresh context carries the same plan: the death fired once
    plan = got["context"].fault_plan
    assert plan is not None and [d.fired for d in plan.deaths] == [True]


def _zeroed_optimizer_state(restore):
    def broken(self, *a, **k):
        step, params, opt_state, extra = restore(self, *a, **k)
        return step, params, {
            m: ({n: torch.zeros_like(t) if t.is_floating_point() else t
                 for n, t in v.items()} if isinstance(v, dict) else v)
            for m, v in opt_state.items()}, extra
    return broken


def _skipped_step(restore):
    def broken(self, *a, **k):
        step, params, opt_state, extra = restore(self, *a, **k)
        return step + 1, params, opt_state, extra
    return broken


def _global_params(cfg, run):
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.launch.train import to_global
    from repro_torch.models import schema as sch
    mesh = run["mesh"]
    specs = sch.partition_specs(cfg, mesh,
                                rules_for_ctx(ParallelCtx.from_mesh(mesh)))
    return {n: t.double() for n, t in
            to_global(run["params"], specs, mesh).items()}


@pytest.mark.parametrize("restore,faithful", [
    (None, True), (_zeroed_optimizer_state, False), (_skipped_step, False)],
    ids=["faithful", "zeroed-optimizer-state", "skipped-step"])
def test_elastic_restore_parameters_tell_a_broken_restore(
        tmp_path, monkeypatch, restore, faithful):
    """The card's elastic check, at the reduced config: a faithful restore
    keeps every final parameter within a relative 5e-3 of the
    uninterrupted run's (the restored mesh's reduction order, in bf16);
    a restore that zeroes the optimizer state or skips the resumed step
    moves some tensor by 1e-2 or more, where the final loss barely moves
    for the first."""
    from repro_torch import configs
    from repro_torch.core.context import reset_default_context
    from repro_torch.launch.train import main
    from repro_torch.train.checkpoint import CheckpointManager
    common = ["--arch", "stablelm-3b", "--reduced", "--steps", "4",
              "--batch", "4", "--seq", "16", "--microbatch", "2",
              "--mesh", "data=2,model=2", "--device", "cpu"]
    try:
        want = main(common)
        if restore is not None:
            monkeypatch.setattr(CheckpointManager, "restore",
                                restore(CheckpointManager.restore))
        got = main(common + ["--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "5", "--chaos-seed", "36",
                             "--chaos-p", "0.3", "--kill-rank-step", "1",
                             "--max-restarts", "1"])
    finally:
        reset_default_context()
    assert got["restarts"] == 1 and got["mesh"].size == 2
    cfg = configs.get_reduced("stablelm-3b")
    a, b = _global_params(cfg, want), _global_params(cfg, got)
    gap = max(float((b[n] - p).norm() / p.norm()) for n, p in a.items())
    if faithful:
        assert gap <= 5e-3, gap
        assert max(abs(x - y) for x, y in
                   zip(got["losses"], want["losses"])) <= 1e-4
    else:
        assert gap >= 1e-2, gap
