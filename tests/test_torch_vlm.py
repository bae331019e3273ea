"""The port's VLM family (paligemma) held against the JAX package's.

Reduced ``paligemma-3b`` (8 heads on 1 kv head, so its attention is
token-parallel: heads that do not divide MAX_TP) runs on the 8-rank smoke
mesh (pod 2 x data 2 x model 2) with the reference's weights carried over
by ``params_from_reference`` (the tied ``embed/table``, no ``lm_head``).
Under ``seq_parallel="allgather"`` and ``"ring"``:

* the schema and its specs equal the reference's, and the weights
  round-trip;
* the prefill (token-parallel, all-gathered K/V), chunked-prefill (under
  ``"ring"`` the fused ring over the cache's S-stripes, offsets from
  tensors) and decode steps give the reference steps' logits and caches —
  1e-5 of the logits' scale with float32 weights, 2e-2 with bfloat16 (the
  reference's own decode-vs-forward bound) — and the same call and byte
  logs for one call;
* a prompt behind prefix embeddings (the SigLIP stub) runs the prefix
  window through the all-gather path as the reference's does;
* ``attention_block`` under ``"ring"`` (the token-parallel fused ring, no
  cache) equals the all-gather path within 3e-5, and the reference's
  all-gather block; this mirrors the reference's
  ``test_attention_block_seq_parallel_ring_matches_allgather``, which does
  not run on jax 0.9 (it passes ``check_rep``);
* the serving engine's greedy tokens, step counts, KV stats and SLO
  decision log equal the reference engine's.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models import transformer as j_tr
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ParallelCtx as JCtx
from repro.serve import slo as j_slo
from repro.serve import step as j_step
from repro.serve.engine import ServeEngine as JEngine

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import (local_shape, params_from_reference,
                                 stack_shards, unstack_shards)
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models import layers, schema
from repro_torch.models.config import ModelConfig, ParallelCtx
from repro_torch.models.transformer import transformer_prefill
from repro_torch.serve import slo
from repro_torch.serve import step as t_step
from repro_torch.serve.engine import ServeEngine

from test_torch_models import DTYPES, MESH, _Both, _np, _padded, _tokens
from test_torch_serve import _drive, _same_requests, _serve

ARCH = "paligemma-3b"
SP = ("allgather", "ring")
B, S = 4, 32


def _both(dt, mesh8, sp):
    both = _Both(ARCH, dt, mesh8)
    both.jctx = dataclasses.replace(both.jctx, seq_parallel=sp)
    both.ctx = dataclasses.replace(both.ctx, seq_parallel=sp)
    return both


# -- schema and weights ----------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_schema_and_specs_equal_reference(full, mesh8):
    get = (configs.get, j_configs.get) if full else \
        (configs.get_reduced, j_configs.get_reduced)
    cfg, jcfg = get[0](ARCH), get[1](ARCH)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    mine, ref = schema.build_schema(cfg), j_sch.build_schema(jcfg)
    assert sorted(mine) == sorted(ref) and "lm_head" not in mine
    for name, spec in mine.items():
        r = ref[name]
        assert (spec.shape, spec.axes, spec.dtype, spec.init, spec.scale) \
            == (r.shape, r.axes, r.dtype, r.init, r.scale), name
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16})
    for tmesh, jmesh in ((MESH, mesh8), (make_production_mesh(), prod)):
        specs = schema.partition_specs(cfg, tmesh)
        jspecs = j_sch.partition_specs(jcfg, jmesh)
        for name, spec in specs.items():
            assert spec == _padded(jspecs[name], len(mine[name].shape)), name
        # the vocabulary is sharded over "model"; the heads are not
        assert specs["embed/table"][0] == "model"
        assert specs["layers/wq"][2] is None
    assert cfg.param_count() == jcfg.param_count()


def test_params_round_trip():
    cfg = configs.get_reduced(ARCH)
    ref = {k: _np(v) for k, v in j_sch.init_params(
        j_configs.get_reduced(ARCH), jax.random.PRNGKey(0)).items()}
    mine = params_from_reference(cfg, MESH, ref)
    specs = schema.partition_specs(cfg, MESH)
    for name, t in mine.items():
        assert tuple(t.shape) == local_shape(ref[name].shape, MESH,
                                             specs[name])
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


# -- the serve steps ----------------------------------------------------------------

@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_matches_reference(dt, sp, mesh8):
    both = _both(dt, mesh8, sp)
    rng = np.random.RandomState(1)
    toks = _tokens(rng, (B, 8), both.cfg)
    js = j_step.build_prefill_step(both.jcfg, mesh8, both.jctx, B=B,
                                   S_prompt=8, S_cache=S, donate=False)
    ts = t_step.build_prefill_step(both.cfg, MESH, both.ctx, B=B, S_cache=S)
    jc, tc = both.caches(B, ts)
    res = both.run(js, ts, (both.jp, toks, jc),
                   (both.tp, stack_shards(toks, MESH, ts.token_spec), tc))
    both.check(*res, ts)
    assert both.dc.stats() == both.jdc.stats()
    assert both.dc.byte_stats() == both.jdc.byte_stats()


@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_chunk_prefill_matches_reference(dt, sp, mesh8):
    """Three chunks of 8 into one slot: full ones, then 5 real tokens and a
    padded tail.  Under "ring" each rank folds its S-stripe of the cache
    (16 rows a rank) with the chunk's shared queries riding the ring; the
    call and byte logs of the first call hold the ring's puts."""
    both = _both(dt, mesh8, sp)
    rng = np.random.RandomState(2)
    js = j_step.build_chunk_prefill_step(both.jcfg, mesh8, both.jctx, C=8,
                                         S_cache=S)
    ts = t_step.build_chunk_prefill_step(both.cfg, MESH, both.ctx, C=8,
                                         S_cache=S)
    jc, tc = both.caches(1, ts)
    for i, rlen in enumerate((8, 8, 5)):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :rlen] = _tokens(rng, rlen, both.cfg)
        jl, jc, tl, tc = both.run(
            js, ts, (both.jp, toks, jc, jnp.asarray(rlen, jnp.int32)),
            (both.tp, stack_shards(toks, MESH, ts.token_spec), tc, rlen))
        both.check(jl, jc, tl, tc, ts)
        if i == 0:
            assert both.dc.stats() == both.jdc.stats()
            assert both.dc.byte_stats() == both.jdc.byte_stats()
            assert both.dc.rma.window_bytes == both.jdc.rma.window_bytes
            tp = both.ctx.tp_group.descriptor()
            puts = both.dc.stats()[tp].get("put", 0)
            assert puts == (2 if sp == "ring" else 0)   # K and V, n = 2


@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_matches_reference(dt, sp, mesh8):
    """Three continuous-batching decode steps over a random cache with
    per-slot positions (one slot parked on the last row)."""
    both = _both(dt, mesh8, sp)
    rng = np.random.RandomState(3)
    js = j_step.build_decode_step(both.jcfg, mesh8, both.jctx, B=B, S=S,
                                  donate=False, slot_pos=True)
    ts = t_step.build_decode_step(both.cfg, MESH, both.ctx, B=B, S=S,
                                  slot_pos=True)
    jc, tc = both.caches(B, ts, rng=rng,
                         pos=np.array([8, 3, S - 1, 5], np.int32))
    for _ in range(3):
        toks = _tokens(rng, (B, 1), both.cfg)
        jl, jc, tl, tc = both.run(
            js, ts, (both.jp, toks, jc),
            (both.tp, stack_shards(toks, MESH, ts.token_spec), tc))
        both.check(jl, jc, tl, tc, ts)
        pos = np.minimum(np.asarray(jc["pos"]), S - 1)   # re-park
        jc["pos"] = jnp.asarray(pos)
        tc["pos"] = stack_shards(pos, MESH, ts.cache_specs["pos"])


def test_prefill_behind_prefix_embeds_matches_reference(mesh8):
    """4 patch embeddings then 8 tokens: the prefix window goes into the
    token-parallel all-gather flash as the reference's does."""
    both = _both("f32", mesh8, "allgather")
    rng = np.random.RandomState(4)
    toks = _tokens(rng, (B, 8), both.cfg)
    prefix = rng.randn(B, 4, both.cfg.d_model).astype(np.float32)
    ts = t_step.build_prefill_step(both.cfg, MESH, both.ctx, B=B, S_cache=S)
    jc, tc = both.caches(B, ts)
    jctx = dataclasses.replace(both.jctx, inference=True)
    from repro.distributed.sharding import rules_for_ctx
    from repro.models import api as j_api
    pspecs = j_sch.partition_specs(both.jcfg, mesh8, rules_for_ctx(jctx))
    _, cspecs = j_api.cache_structs(both.jcfg, mesh8, jctx, B, S)
    bpart = j_api._batch_axes(mesh8, B)

    def step(params, tokens, cache, pe):
        return j_tr.transformer_prefill(params, tokens, both.jcfg, jctx,
                                        cache, prefix_embeds=pe)

    js = jax.jit(shard_map(
        step, mesh=mesh8, in_specs=(pspecs, P(bpart), cspecs, P(bpart)),
        out_specs=(P(bpart, None, "model"), cspecs)))
    with j_use_default(both.jdc):
        jl, jc = js(both.jp, toks, jc, prefix)
    bspec = (tuple(bpart), None, None)
    with use_default(both.dc):
        tl, tc = transformer_prefill(
            both.tp, stack_shards(toks, MESH, ts.token_spec), both.cfg,
            both.ctx, tc,
            prefix_embeds=stack_shards(prefix, MESH, bspec))
    both.check(jl, jc, tl, tc, ts)


# -- attention_block: the ring against the all-gather --------------------------

def test_attention_block_ring_matches_allgather():
    """The reference's test at tests/test_ring_attention.py:280 on the port:
    8 heads on 2 kv heads (token-parallel) over model 4 x data 1; the ring
    branch (no cache) equals the all-gather branch within 3e-5, and both
    equal the reference's all-gather block (run under shard_map without
    ``check_rep``)."""
    kw = dict(name="t", family="dense", num_layers=1, d_model=64,
              num_heads=8, kv_heads=2, d_ff=128, vocab_size=32,
              dtype="float32")
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    jmesh = make_mesh((4, 1), ("model", "data"), axis_types="auto")
    mesh = RankMesh(("model", "data"), (4, 1))
    jparams = j_sch.init_params(jcfg, jax.random.PRNGKey(0))
    lp_j = {kk.split("/")[1]: vv[0] for kk, vv in jparams.items()
            if kk.startswith("layers/")}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 32, cfg.d_model), jnp.float32))
    params = params_from_reference(cfg, mesh, {k: _np(v) for k, v in
                                               jparams.items()},
                                   dtype=torch.float32)
    lp = {kk.split("/")[1]: vv.select(2, 0) for kk, vv in params.items()
          if kk.startswith("layers/")}
    ctx = ParallelCtx.from_mesh(mesh)
    assert not schema.head_parallel(cfg)
    outs = {}
    for sp in SP:
        c = dataclasses.replace(ctx, seq_parallel=sp)
        dc = DiompContext(mesh=mesh, device="cpu")
        with use_default(dc):
            out, _ = layers.attention_block(
                stack_shards(x, mesh, (None, None, None)), lp, cfg, c)
        outs[sp] = out
        for r in range(1, 4):            # the tokens come back replicated
            assert torch.equal(out[r], out[0])
        tp = c.tp_group.descriptor()
        assert dc.stats()[tp].get("put", 0) == (6 if sp == "ring" else 0)
    torch.testing.assert_close(outs["ring"], outs["allgather"], atol=3e-5,
                               rtol=3e-5)

    jctx = JCtx.from_mesh(jmesh)

    def f(x):
        out, _ = j_layers.attention_block(x, lp_j, jcfg, jctx)
        return out[None]

    want = np.asarray(jax.jit(shard_map(
        f, mesh=jmesh, in_specs=(P(),), out_specs=P(("model", "data"))))(x))
    for sp in SP:
        got = outs[sp].reshape(4, *outs[sp].shape[2:]).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


# -- the serving engine ----------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    jp = {k: v.astype(jnp.float32) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    tp = params_from_reference(cfg, MESH, {k: np.array(v)
                                           for k, v in jp.items()},
                               dtype=torch.float32)
    return jp, tp


def _engines(mesh8, weights, sp, **kw):
    jp, tp = weights
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    j = JEngine(jcfg, mesh8, JCtx.from_mesh(mesh8, remat=False,
                                            inference=True, seq_parallel=sp),
                jp, context=JContext(mesh=mesh8, segment_bytes=1 << 26,
                                     allocator="buddy"), **kw)
    t = ServeEngine(cfg, MESH, ParallelCtx.from_mesh(
        MESH, remat=False, inference=True, seq_parallel=sp), tp,
        context=DiompContext(mesh=MESH, device="cpu", segment_bytes=1 << 26,
                             allocator="buddy"), **kw)
    return j, t


LENGTHS = (3, 9, 17, 5, 26)


@pytest.mark.parametrize("sp", SP)
def test_engine_matches_reference(mesh8, weights, sp):
    """Continuous batching with chunked prefill over mixed lengths (the
    chunk steps over a 64-row cache, 32 rows a ring stripe)."""
    j, t = _engines(mesh8, weights, sp, slots=2, max_len=64,
                    prefill_chunk=8)
    _same_requests(_serve(j, LENGTHS), _serve(t, LENGTHS))
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)
    assert t.kv_stats == j.kv_stats
    tp = ParallelCtx.from_mesh(MESH).tp_group.descriptor()
    assert t.dctx.stats()[tp].get("put", 0) == (2 if sp == "ring" else 0)


def test_slo_decision_log_matches_reference_under_ring(mesh8, weights):
    pol = dict(max_queue=6, queue_high=2, queue_low=1, min_step_s=0.01,
               degrade_sustain_steps=2, degrade_recover_steps=2,
               degraded_max_new=2)
    jclk, tclk = j_slo.ManualClock(), slo.ManualClock()
    j, _ = _engines(mesh8, weights, "ring", slots=1, max_len=64,
                    prefill_chunk=8, clock=jclk,
                    slo=j_slo.SLOPolicy(default_tier=j_slo.TierPolicy(
                        ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    _, t = _engines(mesh8, weights, "ring", slots=1, max_len=64,
                    prefill_chunk=8, clock=tclk,
                    slo=slo.SLOPolicy(default_tier=slo.TierPolicy(
                        ttft_deadline_s=0.4, total_deadline_s=1.2), **pol))
    j, t = _drive(j, jclk), _drive(t, tclk)
    assert len(j.slo_log) > 0 and t.slo_log == j.slo_log
    assert t.shed == j.shed
    assert [r.out for r in t._all] == [r.out for r in j._all]
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)


def test_chunked_equals_token_by_token_under_ring(weights):
    """The chunked engine (the ring over the cache's stripes) gives the
    token-by-token baseline's greedy tokens (prefill_chunk=1, decode steps
    only)."""
    _, tp = weights
    cfg = configs.get_reduced(ARCH)
    out = {}
    for chunk in (1, 8):
        eng = ServeEngine(
            cfg, MESH, ParallelCtx.from_mesh(MESH, remat=False,
                                             inference=True,
                                             seq_parallel="ring"), tp,
            context=DiompContext(mesh=MESH, device="cpu",
                                 segment_bytes=1 << 26, allocator="buddy"),
            slots=2, max_len=64, prefill_chunk=chunk)
        out[chunk] = [r.out for r in _serve(eng, LENGTHS)]
    assert out[1] == out[8]
