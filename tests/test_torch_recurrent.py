"""The port's recurrent families held against the JAX package's.

Reduced ``rwkv6-7b`` (RWKV6: token shift, decay LoRA, the WKV scan with
its bonus, a channel mix that all-gathers each rank's slice) and reduced
``zamba2-1.2b`` (Mamba2 layers with a causal conv and an SSD scan, and the
shared attention+MLP block with one KV cache an application) run on the
8-rank smoke mesh (pod 2 x data 2 x model 2, the reference's ``mesh8``).
The schema and its placement specs must equal the reference's; the weights
carried over with ``params_from_reference`` must round-trip exactly; the
prefill step (from a zero state) and three decode steps (after it, and
from a random state) must give the reference ``shard_map`` steps' logits
and states.  Tolerances: with float32 weights and states, 1e-5 of the
logits' scale (both sum in f32, in another order); with the schema's
bfloat16, 2e-2 of it, the reference's own decode-vs-forward bound.  The
call and byte logs of one built step must equal the reference's for one
trace of it.
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
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import api, rwkv, schema, ssm
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import step as t_step

ARCHS = ("rwkv6-7b", "zamba2-1-2b")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S, SP = 4, 16, 8
MESH = make_smoke_mesh(8)


def _padded(spec, ndim):
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(p) if isinstance(p, list) else p for p in parts)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _build(pairs):
    out = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


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
    prod = types.SimpleNamespace(shape={"data": 16, "model": 16})
    for tmesh, jmesh in ((MESH, mesh8), (make_production_mesh(), prod)):
        specs = schema.partition_specs(cfg, tmesh)
        jspecs = j_sch.partition_specs(jcfg, jmesh)
        for name, spec in specs.items():
            assert spec == _padded(jspecs[name], len(mine[name].shape)), name
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_structs_equal_reference(arch, mesh8):
    cfg, jcfg = configs.get_reduced(arch), j_configs.get_reduced(arch)
    ctx = ParallelCtx.from_mesh(MESH, inference=True)
    jctx = JCtx.from_mesh(mesh8, inference=True)
    structs, specs = api.cache_structs(cfg, MESH, ctx, B, S)
    jstructs, jspecs = j_api.cache_structs(jcfg, mesh8, jctx, B, S)
    assert [p for p, _ in _leaves(structs)] == \
        [p for p, _ in _leaves(jstructs)]
    for path, st in _leaves(structs):
        js = _get(jstructs, path)
        assert st.shape == js.shape, path
        assert str(st.dtype).split(".")[-1] == str(js.dtype), path
        assert _get(specs, path) == _padded(_get(jspecs, path), len(js.shape))
    assert api.supports_long_context(cfg)


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
        assert t.dtype == schema.torch_dtype(schema.build_schema(cfg)[name]
                                             .dtype)
        assert tuple(t.shape) == local_shape(ref[name].shape, MESH,
                                             specs[name])
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


class _Both:
    """One arch in both packages: weights, contexts, states."""

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

    def steps(self):
        js_pre = j_step.build_prefill_step(self.jcfg, self.mesh8, self.jctx,
                                           B=B, S_prompt=SP, S_cache=S,
                                           donate=False)
        js_dec = j_step.build_decode_step(self.jcfg, self.mesh8, self.jctx,
                                          B=B, S=S, donate=False)
        ts_pre = t_step.build_prefill_step(self.cfg, MESH, self.ctx, B=B,
                                           S_cache=S)
        ts_dec = t_step.build_decode_step(self.cfg, MESH, self.ctx, B=B, S=S)
        return js_pre, js_dec, ts_pre, ts_dec

    def states(self, step, rng=None, pos=0):
        """The same state in both packages (zeros, or random values with
        the cache position at ``pos``).  Float leaves of the cache dtype
        are held in the run's dtype; the f32 scan states stay f32."""
        structs, _ = j_api.cache_structs(self.jcfg, self.mesh8, self.jctx,
                                         B, S)
        jpairs, tpairs = [], []
        for path, s in _leaves(structs):
            spec = _get(step.cache_specs, path)
            if path[-1] == "pos":
                glob = np.asarray(pos, np.int32)
                jpairs.append((path, jnp.asarray(glob)))
                tpairs.append((path, stack_shards(glob, MESH, spec)))
                continue
            dt = jnp.float32 if s.dtype == jnp.float32 else self.jdt
            glob = (rng.randn(*s.shape) * 0.5 if rng is not None
                    else np.zeros(s.shape)).astype(np.float32)
            glob = _np(jnp.asarray(glob).astype(dt))
            jpairs.append((path, jnp.asarray(glob).astype(dt)))
            tpairs.append((path, stack_shards(
                glob, MESH, spec,
                dtype=torch.float32 if dt == jnp.float32 else self.tdt)))
        return _build(jpairs), _build(tpairs)

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
        assert np.all(np.isfinite(got))
        assert np.abs(got - want).max() <= self.tol * scale
        for path, leaf in _leaves(jc):
            w = _np(leaf)
            g = unstack_shards(_get(tc, path), MESH,
                               _get(tstep.cache_specs, path))
            if path[-1] == "pos":
                np.testing.assert_array_equal(g, w)
            else:
                assert g.shape == w.shape, path
                assert np.abs(g - w).max() <= \
                    self.tol * max(np.abs(w).max(), 1), path


def _tokens(rng, shape, cfg):
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, dt, mesh8):
    """A prompt of 8 tokens into a zero state, then three random-token
    decode steps on the returned state."""
    both = _Both(arch, dt, mesh8)
    rng = np.random.RandomState(1)
    js_pre, js_dec, ts_pre, ts_dec = both.steps()
    jc, tc = both.states(ts_pre)
    toks = _tokens(rng, (B, SP), both.cfg)
    res = both.run(js_pre, ts_pre, (both.jp, toks, jc),
                   (both.tp, stack_shards(toks, MESH, ts_pre.token_spec), tc))
    both.check(*res, ts_pre)
    _, jc, _, tc = res
    for _ in range(3):
        toks = _tokens(rng, (B, 1), both.cfg)
        jl, jc, tl, tc = both.run(
            js_dec, ts_dec, (both.jp, toks, jc),
            (both.tp, stack_shards(toks, MESH, ts_dec.token_spec), tc))
        both.check(jl, jc, tl, tc, ts_dec)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_random_state_matches_reference(arch, dt, mesh8):
    """Three decode steps from a random state (and, for the hybrid, a
    random KV cache at position 5)."""
    both = _Both(arch, dt, mesh8)
    rng = np.random.RandomState(2)
    _, js_dec, _, ts_dec = both.steps()
    jc, tc = both.states(ts_dec, rng=rng, pos=5)
    for _ in range(3):
        toks = _tokens(rng, (B, 1), both.cfg)
        jl, jc, tl, tc = both.run(
            js_dec, ts_dec, (both.jp, toks, jc),
            (both.tp, stack_shards(toks, MESH, ts_dec.token_spec), tc))
        both.check(jl, jc, tl, tc, ts_dec)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_logs_once_per_built_step(arch, kind, mesh8):
    """A built step logs its collectives on its first call (the reference
    traces its jitted step once) and replays later calls silently: RWKV's
    layer scan logs one layer, Zamba's unrolled loop logs every layer and
    every shared-block application."""
    both = _Both(arch, "f32", mesh8)
    rng = np.random.RandomState(4)
    js_pre, js_dec, ts_pre, ts_dec = both.steps()
    js, ts = (js_pre, ts_pre) if kind == "prefill" else (js_dec, ts_dec)
    jc, tc = both.states(ts)
    toks = _tokens(rng, (B, SP if kind == "prefill" else 1), both.cfg)
    with j_use_default(both.jdc):
        jax.eval_shape(js, both.jp, toks, jc)          # one trace
    for _ in range(2):
        with use_default(both.dc):
            ts(both.tp, stack_shards(toks, MESH, ts.token_spec), tc)
    assert both.dc.stats() == both.jdc.stats()
    assert both.dc.byte_stats() == both.jdc.byte_stats()
    tp = both.jdc.stats()
    assert sum(sum(v.values()) for v in tp.values()) > 0


def test_unported_recurrent_branches_raise():
    ctx = ParallelCtx.from_mesh(MESH, inference=True)
    rw = configs.get_reduced("rwkv6-7b")
    zb = configs.get_reduced("zamba2-1-2b")
    with pytest.raises(NotImplementedError, match="item 19"):
        rwkv.rwkv_loss({}, {}, rw, ctx)
    with pytest.raises(NotImplementedError, match="item 19"):
        ssm.zamba_loss({}, {}, zb, ctx)
    with pytest.raises(NotImplementedError, match="item 9"):
        ssm.zamba_forward({}, None, zb, ctx, seq_sharded=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        api.cache_structs(zb, MESH, ctx, B, S, seq_sharded=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        t_step.build_decode_step(zb, MESH, ctx, B=B, S=S, seq_sharded=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_is_the_zero_cache(arch):
    """``rwkv_init_state``/``zamba_init_state`` lay out the zero cache that
    ``cache_structs`` describes, on the active context's device."""
    cfg = configs.get_reduced(arch)
    ctx = ParallelCtx.from_mesh(MESH, inference=True)
    structs, specs = api.cache_structs(cfg, MESH, ctx, B, S)
    B_loc = B // (MESH.shape["pod"] * MESH.shape["data"])
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        st = (rwkv.rwkv_init_state(cfg, ctx, B_loc) if cfg.family == "ssm"
              else ssm.zamba_init_state(cfg, ctx, B_loc, S))
    for path, s in _leaves(structs):
        t = _get(st, path)
        assert t.device.type == "cpu" and t.dtype == s.dtype, path
        assert tuple(t.shape) == local_shape(s.shape, MESH,
                                             _get(specs, path)), path
        assert not t.any(), path
