"""The port's model stack held against the JAX package's, dense family.

Reduced ``glm4-9b`` (GQA 8:1 with replicated KV weights, half-dim rotary),
reduced ``stablelm-3b`` (MHA, KV heads sharded), reduced ``qwen1.5-110b``
(QKV bias, GQA 2:1) and reduced ``command-r-plus-104b`` (GQA 2:1, rope
theta 75e6) run on the 8-rank smoke mesh (pod 2 x data 2 x model 2, the reference's ``mesh8``): the
schema and its placement specs must equal the reference's; the weights
carried over with ``params_from_reference`` must round-trip exactly; and
the prefill, chunked-prefill (with a padded tail) and decode (per-slot
positions) steps must give the reference ``shard_map`` steps' logits and
caches.  Tolerances: with float32 weights and caches, 1e-5 of the logits'
scale (both sum in f32, in another order); with the schema's bfloat16,
2e-2 of it, the reference's own decode-vs-forward bound (every matmul
output is rounded to a 7-bit mantissa, at other places in the two
frameworks).  The call and byte logs of one built step must equal the
reference's for one trace of it.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as j_configs
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.models import api as j_api
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.serve import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import (local_shape, params_from_reference,
                                 stack_shards, unstack_shards)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import api, schema
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import step as t_step

ARCHS = ("glm4-9b", "stablelm-3b", "qwen1-5-110b", "command-r-plus-104b")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S = 4, 32
MESH = make_smoke_mesh(8)


def _padded(spec, ndim):
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(p) if isinstance(p, list) else p for p in parts)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_schema_and_specs_equal_reference(arch, full, mesh8):
    get = (configs.get, j_configs.get) if full else \
        (configs.get_reduced, j_configs.get_reduced)
    cfg, jcfg = get[0](arch), get[1](arch)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    mine, ref = schema.build_schema(cfg), j_sch.build_schema(jcfg)
    assert sorted(mine) == sorted(ref)
    for name, spec in mine.items():
        r = ref[name]
        assert (spec.shape, spec.axes, spec.dtype, spec.init, spec.scale) \
            == (r.shape, r.axes, r.dtype, r.init, r.scale), name
    # placement on the smoke mesh and on the production 16 x 16 mesh
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16})
    from repro_torch.launch.mesh import make_production_mesh
    for tmesh, jmesh in ((MESH, mesh8), (make_production_mesh(), prod)):
        specs = schema.partition_specs(cfg, tmesh)
        jspecs = j_sch.partition_specs(jcfg, jmesh)
        for name, spec in specs.items():
            assert spec == _padded(jspecs[name], len(mine[name].shape)), name
    assert cfg.param_count() == jcfg.param_count()


def _ref_params(arch, dt):
    cfg = j_configs.get_reduced(arch)
    p = j_sch.init_params(cfg, jax.random.PRNGKey(0))
    return {k: v.astype(DTYPES[dt][0]) for k, v in p.items()}


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    cfg = configs.get_reduced(arch)
    ref = {k: _np(v) for k, v in _ref_params(arch, "bf16").items()}
    mine = params_from_reference(cfg, MESH, ref)
    specs = schema.partition_specs(cfg, MESH)
    for name, t in mine.items():
        assert t.dtype == torch.bfloat16
        assert tuple(t.shape) == local_shape(ref[name].shape, MESH,
                                             specs[name])
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


class _Both:
    """One arch in both packages: weights, contexts, caches."""

    def __init__(self, arch, dt, mesh8):
        self.cfg, self.jcfg = configs.get_reduced(arch), \
            j_configs.get_reduced(arch)
        self.jdt, self.tdt, self.tol = DTYPES[dt]
        self.jp = _ref_params(arch, dt)
        self.tp = params_from_reference(
            self.cfg, MESH, {k: _np(v) for k, v in self.jp.items()},
            dtype=self.tdt)
        self.mesh8 = mesh8
        self.jctx = JCtx.from_mesh(mesh8, remat=False, inference=True)
        self.ctx = ParallelCtx.from_mesh(MESH, remat=False, inference=True)
        self.jdc, self.dc = JContext(mesh=mesh8), \
            DiompContext(mesh=MESH, device="cpu")

    def caches(self, Bc, step, rng=None, pos=None):
        """The same cache in both packages (zeros, or random rows)."""
        structs, _ = j_api.cache_structs(self.jcfg, self.mesh8, self.jctx,
                                         Bc, S)
        glob = {k: (rng.randn(*s.shape).astype(np.float32) if rng is not None
                    else np.zeros(s.shape, np.float32))
                for k, s in structs.items() if k != "pos"}
        glob = {k: _np(jnp.asarray(v).astype(self.jdt))
                for k, v in glob.items()}
        pos = np.zeros((), np.int32) if pos is None else pos
        jc = {k: jnp.asarray(v).astype(self.jdt) for k, v in glob.items()}
        jc["pos"] = jnp.asarray(pos)
        tc = {k: stack_shards(v, MESH, step.cache_specs[k], dtype=self.tdt)
              for k, v in glob.items()}
        tc["pos"] = stack_shards(pos, MESH, step.cache_specs["pos"])
        return jc, tc

    def run(self, jstep, tstep, jargs, targs):
        with j_use_default(self.jdc):
            jl, jc = jstep(*jargs)
        with use_default(self.dc):
            tl, tc = tstep(*targs)
        return jl, jc, tl, tc

    def check(self, jl, jc, tl, tc, tstep):
        want = np.asarray(jl, np.float32)
        got = unstack_shards(tl, MESH, tstep.logits_spec)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= self.tol * scale
        for k in ("k", "v"):
            w = _np(jc[k])
            g = unstack_shards(tc[k], MESH, tstep.cache_specs[k])
            assert np.abs(g - w).max() <= self.tol * max(np.abs(w).max(), 1)
        np.testing.assert_array_equal(
            unstack_shards(tc["pos"], MESH, tstep.cache_specs["pos"]),
            np.asarray(jc["pos"]))


def _tokens(rng, shape, cfg):
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dt, mesh8):
    both = _Both(arch, dt, mesh8)
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


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_prefill_matches_reference(arch, dt, mesh8):
    """Two chunks of 8 into one slot: a full one, then 5 real tokens and a
    padded tail."""
    both = _Both(arch, dt, mesh8)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dt, mesh8):
    """Three continuous-batching decode steps over a random cache with
    per-slot positions (one slot parked on the last row)."""
    both = _Both(arch, dt, mesh8)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_step_logs_once_per_built_step(arch, mesh8):
    """A built step logs its collectives on its first call (the reference
    traces its jitted step once) and replays later calls silently."""
    both = _Both(arch, "f32", mesh8)
    rng = np.random.RandomState(4)
    js = j_step.build_decode_step(both.jcfg, mesh8, both.jctx, B=B, S=S,
                                  donate=False, slot_pos=True)
    ts = t_step.build_decode_step(both.cfg, MESH, both.ctx, B=B, S=S,
                                  slot_pos=True)
    jc, tc = both.caches(B, ts, pos=np.array([1, 2, 3, 4], np.int32))
    toks = _tokens(rng, (B, 1), both.cfg)
    with j_use_default(both.jdc):
        jax.eval_shape(js, both.jp, toks, jc)          # one trace
    for _ in range(2):
        with use_default(both.dc):
            _, tc = ts(both.tp, stack_shards(toks, MESH, ts.token_spec), tc)
    assert both.dc.stats() == both.jdc.stats()
    assert both.dc.byte_stats() == both.jdc.byte_stats()
    tp = both.jdc.stats()
    assert sum(sum(v.values()) for v in tp.values()) > 0


def test_unported_branches_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        configs.get("hubert-xlarge")
    ctx = ParallelCtx.from_mesh(MESH)
    with pytest.raises(NotImplementedError, match="item 8"):
        ParallelCtx.from_mesh(MESH, layout="dp_only")
    cfg = configs.get_reduced("glm4-9b")
    audio = type(cfg)(**{**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__},
                         "family": "audio", "causal": False})
    with pytest.raises(NotImplementedError, match="item 9"):
        schema.build_schema(audio)
    with pytest.raises(NotImplementedError, match="item 9"):
        api.cache_structs(cfg, MESH, ctx, B, S, seq_sharded=True)
