"""The port's MLA model stack (deepseek-v3) held against the JAX package's.

* ``mla_block``'s three paths (prefill, with and without a cache; chunked
  prefill at a running position; the absorbed decode at a scalar and at
  per-slot positions) against the reference's ``mla_block`` in
  ``shard_map`` on the data 1 x model 8 mesh, with random weights.
* Reduced ``deepseek-v3-671b`` (one leading dense layer, two MoE layers,
  the MTP leaves) on the 8-rank smoke mesh (pod 2 x data 2 x model 2): the
  schema and its placement specs equal the reference's, reduced and full;
  the weights carried with ``params_from_reference`` round-trip; the cache
  structs and ``init_cache`` have the reference's layout; the forward
  pass, prefill, chunked prefill and per-slot decode give the reference
  steps' logits and latent caches under ``dispatch_impl`` ``"auto"`` and
  ``"fused"``; one built step's call and byte logs equal one trace of the
  reference's; and the serving engine gives the reference engine's
  tokens.

Tolerances: with float32 weights, 1e-5 of the output's or logits' scale
(both sum in f32, in another order); with the schema's bfloat16, 2e-2 of
it (``tests/test_torch_models.py``'s bounds: every product rounded to a
7-bit mantissa, at other places in the two frameworks).
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core.backends import ensure_varying
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models import transformer as j_tf
from repro.models.config import ParallelCtx as JCtx
from repro.serve import step as j_step
from repro.serve.engine import ServeEngine as JEngine

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import (local_shape, params_from_reference,
                                 stack_shards, unstack_shards)
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models import api, schema
from repro_torch.models import transformer as tf
from repro_torch.models.config import ParallelCtx
from repro_torch.models.layers import MLACache, mla_block
from repro_torch.serve import step as t_step
from repro_torch.serve.engine import ServeEngine

from test_torch_models import (B, DTYPES, MESH, S, _Both, _np, _padded,
                               _tokens)

ARCH = "deepseek-v3-671b"
LEAVES = ("c", "kr", "dense_c", "dense_kr")
IMPLS = ("auto", "fused")


# -- mla_block --------------------------------------------------------------------

# one layer's MLA weights and their placement on the data 1 x model 8 mesh
# (heads sharded over "model", the latent path replicated)
BLOCK_SPECS = {"wq_a": (None, None), "q_norm": (None,),
               "wq_b": (None, "model"), "wkv_a": (None, None),
               "kv_norm": (None,), "wkv_b": (None, "model"),
               "wo": ("model", None)}


def _block_lp(cfg, seed=0):
    """Random weights at unit gain (std 1/sqrt(fan_in)), norms near one."""
    rng = np.random.RandomState(seed)
    d, H = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    return {"wq_a": w(d, qr), "q_norm": 1 + 0.1 * rng.randn(qr),
            "wq_b": w(qr, H * (dn + dr)), "wkv_a": w(d, kr + dr),
            "kv_norm": 1 + 0.1 * rng.randn(kr),
            "wkv_b": w(kr, H * (dn + dv)), "wo": w(H * dv, d)}


def _block_case(case, cfg, rng):
    """(x, cache leaves or None, positions, chunked) of one path."""
    Bb, Sc = 2, 16
    kr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    T = {"prefill": 8, "prefill_cache": 8, "chunk": 4}.get(case, 1)
    x = rng.randn(Bb, T, cfg.d_model).astype(np.float32)
    if case == "prefill":
        return x, None, np.arange(T), False
    c = rng.randn(Bb, Sc, kr).astype(np.float32)
    r = rng.randn(Bb, Sc, dr).astype(np.float32)
    if case == "prefill_cache":
        return x, (c, r, np.int32(0)), np.arange(T), False
    if case == "chunk":
        return x, (c, r, np.int32(5)), 5 + np.arange(T), True
    if case == "decode":
        return x, (c, r, np.int32(7)), np.array([7]), False
    pos = np.array([3, 9], np.int32)          # decode_slots
    return x, (c, r, pos), pos[:, None], False


def _ref_block(jcfg, lp, x, cache, positions, chunked, jdt):
    mesh = make_mesh((1, 8), ("data", "model"), axis_types="auto")
    ctx = JCtx.from_mesh(mesh, remat=False, inference=True)
    jspecs = {k: P(*v) for k, v in BLOCK_SPECS.items()}
    pos = jnp.asarray(positions)

    def f(xx, pp, *cc):
        mc = j_layers.MLACache(*cc) if cc else None
        out, new = j_layers.mla_block(xx, pp, jcfg, ctx, positions=pos,
                                      cache=mc, chunked=chunked)
        outs = (out,) if new is None else (out, new.c, new.kr, new.pos)
        return tuple(ensure_varying(o, ("model",))[None] for o in outs)

    args = [jnp.asarray(x).astype(jdt),
            {k: jnp.asarray(v).astype(jdt) for k, v in lp.items()}]
    if cache is not None:
        args += [jnp.asarray(cache[0]).astype(jdt),
                 jnp.asarray(cache[1]).astype(jdt), jnp.asarray(cache[2])]
    n_out = 1 if cache is None else 4
    with j_use_default(JContext(mesh=mesh)):
        outs = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P(), jspecs) + (P(),) * (len(args) - 2),
            out_specs=(P("model"),) * n_out))(*args)
    return [_np(o[0]) for o in outs]


def _port_block(cfg, lp, x, cache, positions, chunked, tdt):
    mesh = RankMesh(("data", "model"), (1, 8))
    ctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)

    def rep(a, dtype=tdt):
        return stack_shards(a, mesh, (None,) * np.ndim(a), dtype=dtype)

    tlp = {k: stack_shards(v, mesh, BLOCK_SPECS[k], dtype=tdt)
           for k, v in lp.items()}
    tc = None if cache is None else MLACache(
        rep(cache[0]), rep(cache[1]), rep(cache[2], torch.int32))
    pos = torch.as_tensor(positions) if np.ndim(positions) < 2 \
        else rep(positions, torch.int64)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        out, new = mla_block(rep(x), tlp, cfg, ctx, positions=pos, cache=tc,
                             chunked=chunked)
    outs = (out,) if new is None else (out, new.c, new.kr, new.pos)
    return [o[0, 0].float().numpy() for o in outs]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["prefill", "prefill_cache", "chunk",
                                  "decode", "decode_slots"])
def test_mla_block_paths_match_reference(case, dt):
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.RandomState(11)
    lp = _block_lp(cfg)
    x, cache, positions, chunked = _block_case(case, cfg, rng)
    want = _ref_block(jcfg, lp, x, cache, positions, chunked, jdt)
    got = _port_block(cfg, lp, x, cache, positions, chunked, tdt)
    assert len(got) == len(want)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-6)
    if cache is not None:
        np.testing.assert_array_equal(got[3], want[3])      # positions


# -- the reduced model ------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_schema_and_specs_equal_reference(full, mesh8):
    get = (configs.get, j_configs.get) if full else \
        (configs.get_reduced, j_configs.get_reduced)
    cfg, jcfg = get[0](ARCH), get[1](ARCH)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    mine, ref = schema.build_schema(cfg), j_sch.build_schema(jcfg)
    assert sorted(mine) == sorted(ref)
    assert {n.split("/")[0] for n in mine} >= {"dense_layers", "layers",
                                               "mtp"}
    for name, spec in mine.items():
        r = ref[name]
        assert (spec.shape, spec.axes, spec.dtype, spec.init, spec.scale,
                spec.per_expert) == (r.shape, r.axes, r.dtype, r.init,
                                     r.scale, r.per_expert), name
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16})
    for tmesh, jmesh in ((MESH, mesh8), (make_production_mesh(), prod)):
        specs = schema.partition_specs(cfg, tmesh)
        jspecs = j_sch.partition_specs(jcfg, jmesh)
        for name, spec in specs.items():
            assert spec == _padded(jspecs[name], len(mine[name].shape)), name
    assert cfg.param_count() == jcfg.param_count()


def test_params_round_trip():
    cfg = configs.get_reduced(ARCH)
    ref = {k: _np(v) for k, v in j_sch.init_params(
        j_configs.get_reduced(ARCH), jax.random.PRNGKey(0)).items()}
    mine = params_from_reference(cfg, MESH, ref)
    specs = schema.partition_specs(cfg, MESH)
    assert mine["dense_layers/wkv_b"].dtype == torch.bfloat16
    assert specs["layers/wkv_b"] == (None, "data", "model")
    assert specs["layers/wkv_a"] == (None, "data", None)
    for name, t in mine.items():
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


@pytest.mark.parametrize("slots", [1, B])
def test_cache_structs_and_init_cache_equal_reference(slots, mesh8):
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    ctx = ParallelCtx.from_mesh(MESH, remat=False, inference=True)
    jctx = JCtx.from_mesh(mesh8, remat=False, inference=True)
    structs, specs = api.cache_structs(cfg, MESH, ctx, slots, S)
    jstructs, jspecs = j_api.cache_structs(jcfg, mesh8, jctx, slots, S)
    assert sorted(structs) == sorted(jstructs) == sorted((*LEAVES, "pos"))
    for n, st in structs.items():
        assert st.shape == jstructs[n].shape, n
        assert specs[n] == _padded(jspecs[n], len(st.shape)), n
    # init_cache lays out each rank's share of the same global cache
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        local = tf.init_cache(cfg, ctx, slots // (4 if slots == B else 1), S)
    for n in LEAVES:
        assert tuple(local[n].shape) == local_shape(
            structs[n].shape, MESH,
            specs[n] if slots == B else (None,) * 4), n
    assert tuple(local["pos"].shape) == MESH.sizes


class _MLA(_Both):
    """Reduced deepseek-v3 in both packages under one dispatch_impl."""

    def __init__(self, dt, impl, mesh8):
        super().__init__(ARCH, dt, mesh8)
        self.jctx = JCtx.from_mesh(mesh8, remat=False, inference=True,
                                   dispatch_impl=impl)
        self.ctx = ParallelCtx.from_mesh(MESH, remat=False, inference=True,
                                         dispatch_impl=impl)

    def check(self, jl, jc, tl, tc, tstep):
        want = np.asarray(jl, np.float32)
        got = unstack_shards(tl, MESH, tstep.logits_spec)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= self.tol * np.abs(want).max()
        assert sorted(tc) == sorted(jc) == sorted((*LEAVES, "pos"))
        for k in LEAVES:
            w = _np(jc[k])
            g = unstack_shards(tc[k], MESH, tstep.cache_specs[k])
            assert np.abs(g - w).max() <= self.tol * max(np.abs(w).max(), 1)
        np.testing.assert_array_equal(
            unstack_shards(tc["pos"], MESH, tstep.cache_specs["pos"]),
            np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(impl, mesh8):
    both = _MLA("f32", impl, mesh8)
    toks = _tokens(np.random.RandomState(5), (B, 8), both.cfg)
    pspecs = j_sch.partition_specs(both.jcfg, mesh8)

    def f(p, t):
        return j_tf.transformer_forward(p, t, both.jcfg, both.jctx)[0]

    with j_use_default(both.jdc):
        want = np.asarray(jax.jit(shard_map(
            f, mesh=mesh8, in_specs=(pspecs, P(("pod", "data"))),
            out_specs=P(("pod", "data"))))(both.jp, toks))
    spec = (("pod", "data"), None)
    with use_default(both.dc):
        h, _ = tf.transformer_forward(both.tp, stack_shards(toks, MESH, spec),
                                      both.cfg, both.ctx)
    got = unstack_shards(h, MESH, (*spec, None))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_reference(impl, dt, mesh8):
    both = _MLA(dt, impl, mesh8)
    toks = _tokens(np.random.RandomState(1), (B, 8), both.cfg)
    js = j_step.build_prefill_step(both.jcfg, mesh8, both.jctx, B=B,
                                   S_prompt=8, S_cache=S, donate=False)
    ts = t_step.build_prefill_step(both.cfg, MESH, both.ctx, B=B, S_cache=S)
    jc, tc = both.caches(B, ts)
    res = both.run(js, ts, (both.jp, toks, jc),
                   (both.tp, stack_shards(toks, MESH, ts.token_spec), tc))
    both.check(*res, ts)
    assert both.dc.stats() == both.jdc.stats()
    assert both.dc.byte_stats() == both.jdc.byte_stats()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_prefill_matches_reference(impl, dt, mesh8):
    """Two chunks of 8 into one slot: a full one, then 5 real tokens and a
    padded tail."""
    both = _MLA(dt, impl, mesh8)
    rng = np.random.RandomState(2)
    js = j_step.build_chunk_prefill_step(both.jcfg, mesh8, both.jctx, C=8,
                                         S_cache=S)
    ts = t_step.build_chunk_prefill_step(both.cfg, MESH, both.ctx, C=8,
                                         S_cache=S)
    jc, tc = both.caches(1, ts)
    for rlen in (8, 5):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :rlen] = _tokens(rng, rlen, both.cfg)
        jl, jc, tl, tc = both.run(
            js, ts, (both.jp, toks, jc, jnp.asarray(rlen, jnp.int32)),
            (both.tp, stack_shards(toks, MESH, ts.token_spec), tc, rlen))
        both.check(jl, jc, tl, tc, ts)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_reference(impl, dt, mesh8):
    """Three continuous-batching decode steps (the absorbed form) over a
    random latent cache with per-slot positions, one slot parked on the
    last row; one built step logs its collectives once."""
    both = _MLA(dt, impl, mesh8)
    rng = np.random.RandomState(3)
    js = j_step.build_decode_step(both.jcfg, mesh8, both.jctx, B=B, S=S,
                                  donate=False, slot_pos=True)
    ts = t_step.build_decode_step(both.cfg, MESH, both.ctx, B=B, S=S,
                                  slot_pos=True)
    jc, tc = both.caches(B, ts, rng=rng,
                         pos=np.array([8, 3, S - 1, 5], np.int32))
    toks = _tokens(rng, (B, 1), both.cfg)
    trace = JContext(mesh=mesh8)
    with j_use_default(trace):
        jax.eval_shape(js, both.jp, toks, jc)          # one trace
    for _ in range(3):
        toks = _tokens(rng, (B, 1), both.cfg)
        jl, jc, tl, tc = both.run(
            js, ts, (both.jp, toks, jc),
            (both.tp, stack_shards(toks, MESH, ts.token_spec), tc))
        both.check(jl, jc, tl, tc, ts)
        pos = np.minimum(np.asarray(jc["pos"]), S - 1)   # re-park
        jc["pos"] = jnp.asarray(pos)
        tc["pos"] = stack_shards(pos, MESH, ts.cache_specs["pos"])
    assert both.dc.stats() == trace.stats()
    assert both.dc.byte_stats() == trace.byte_stats()


# -- the serving engine -----------------------------------------------------------

LENGTHS = (3, 9, 17, 5, 12)


def test_engine_serves_like_reference(mesh8):
    """Continuous batching with chunked prefill over mixed lengths through
    the latent cache (the engine reads its slot axes from the cache's first
    leaf, ``c`` here) under the dropless fused dispatch: the reference
    engine's greedy tokens, steps and device calls."""
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    jp = {k: v.astype(jnp.float32) for k, v in
          j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    tp = params_from_reference(cfg, MESH, {k: np.array(v)
                                           for k, v in jp.items()},
                               dtype=torch.float32)
    kw = dict(slots=B, max_len=64, prefill_chunk=8)   # a slot a DP rank
    j = JEngine(jcfg, mesh8, JCtx.from_mesh(
        mesh8, remat=False, inference=True, dispatch_impl="fused"), jp,
        context=JContext(mesh=mesh8, segment_bytes=1 << 26,
                         allocator="buddy"), **kw)
    t = ServeEngine(cfg, MESH, ParallelCtx.from_mesh(
        MESH, remat=False, inference=True, dispatch_impl="fused"), tp,
        context=DiompContext(mesh=MESH, device="cpu", segment_bytes=1 << 26,
                             allocator="buddy"), **kw)
    assert t._slot_axes == ("pod", "data")
    assert sorted(t.cache) == sorted((*LEAVES, "pos"))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in LENGTHS]
    outs = []
    for eng in (j, t):
        reqs = [eng.submit(p, max_new=4) for p in prompts]
        eng.run()
        assert all(r.done and len(r.out) == 4 for r in reqs)
        outs.append([(r.out, r.prefill_steps, r.decode_steps)
                     for r in reqs])
    assert outs[1] == outs[0]
    assert (t.steps, t.device_calls) == (j.steps, j.device_calls)
    assert t.kv_stats == j.kv_stats
