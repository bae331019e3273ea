"""The port's MoE model stack held against the JAX package's.

* ``moe_block`` in its three regimes (a2a: tokens sliced over the EP ring;
  replicated: fewer tokens than ranks; local: E does not divide) and both
  dropless impls (fused, host), on the reference's tiny configs
  (``tests/test_moe_fused.py:331``, ``:354``) with f32 weights, against
  the reference's ``moe_block`` in ``shard_map`` on the data 1 x model 8
  mesh: within 1e-5 of the output's scale (f32 sums in another order),
  and the same drop count where the capacity path drops.
* Reduced ``qwen3-moe-235b-a22b`` on the 8-rank smoke mesh (pod 2 x
  data 2 x model 2): the schema and its placement specs equal the
  reference's, the weights carried with ``params_from_reference``
  round-trip, and the forward pass, prefill, chunked prefill and decode
  give the reference steps' logits and caches under ``dispatch_impl``
  ``"auto"`` (the capacity all-to-all) and ``"fused"`` (the dropless
  ring) — within 1e-5 of the logits' scale with f32 weights, 2e-2 with
  the schema's bf16 (tests/test_torch_models.py's bounds); one built
  step's call and byte logs equal one trace of the reference's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core.backends import ensure_varying
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import default_context as j_default_context
from repro.core.context import use_default as j_use_default
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models import transformer as j_tf
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ParallelCtx as JCtx
from repro.serve import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import (params_from_reference, stack_shards,
                                 unstack_shards)
from repro_torch.kernels.moe_dispatch.fused import fused_moe_dispatch_kernel
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import schema
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, ParallelCtx
from repro_torch.models.layers import moe_block, moe_capacity
from repro_torch.serve import step as t_step

from test_torch_models import (B, DTYPES, MESH, S, _Both, _np, _padded,
                               _tokens)

ARCH = "qwen3-moe-235b-a22b"
RNG = np.random.RandomState(0)


# -- moe_block ----------------------------------------------------------------------

def _moe_cfg(cls, E, shared=0, cf=8.0):
    return cls(name="tiny-moe", family="moe", num_layers=1, d_model=32,
               num_heads=4, d_ff=64, vocab_size=128, moe=True, num_experts=E,
               experts_per_token=2, moe_d_ff=24, shared_experts=shared,
               capacity_factor=cf, dtype="float32")


def _moe_lp(cfg, seed=0):
    rng = np.random.RandomState(seed)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    lp = {
        "router": rng.randn(d, E).astype(np.float32) * 2.0,
        "w_gate_e": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
        "w_up_e": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
        "w_down_e": (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32),
    }
    if cfg.shared_experts:
        fs = cfg.moe_d_ff * cfg.shared_experts
        lp["w_gate_s"] = (rng.randn(d, fs) / np.sqrt(d)).astype(np.float32)
        lp["w_up_s"] = (rng.randn(d, fs) / np.sqrt(d)).astype(np.float32)
        lp["w_down_s"] = (rng.randn(fs, d) / np.sqrt(fs)).astype(np.float32)
    return lp


def _lspecs(lp, sharded):
    espec = ("model", None, None) if sharded else (None, None, None)
    specs = {"router": (None, None), "w_gate_e": espec, "w_up_e": espec,
             "w_down_e": espec}
    if "w_gate_s" in lp:
        specs.update({"w_gate_s": (None, "model"), "w_up_s": (None, "model"),
                      "w_down_s": ("model", None)})
    return specs


def _ref_block(cfg, lp, x, sharded, **knobs):
    mesh = make_mesh((1, 8), ("data", "model"), axis_types="auto")
    ctx = JCtx.from_mesh(mesh, **knobs)
    jspecs = {k: P(*v) for k, v in _lspecs(lp, sharded).items()}

    def f(xx, pp):
        with j_default_context().dispatch_stats.collect() as ds:
            out = j_layers.moe_block(xx, pp, cfg, ctx)
        dropped = ds.get("moe_dropped", jnp.zeros((), jnp.float32))
        return (lax.pmean(out, "model"),
                lax.psum(ensure_varying(dropped, ("model",)), "model"))

    with j_use_default(JContext()):
        out, dropped = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), jspecs),
                                         out_specs=(P(), P())))(x, lp)
    return np.asarray(out), float(dropped)


def _port_block(cfg, lp, x, sharded, **knobs):
    mesh = RankMesh(("data", "model"), (1, 8))
    ctx = ParallelCtx.from_mesh(mesh, **knobs)
    specs = _lspecs(lp, sharded)
    tlp = {k: stack_shards(v, mesh, specs[k]) for k, v in lp.items()}
    dc = DiompContext(mesh=mesh, device="cpu")
    with use_default(dc), dc.dispatch_stats.collect() as ds:
        out = moe_block(stack_shards(x, mesh, (None,) * 3), tlp, cfg, ctx)
    dropped = float(ds["moe_dropped"].sum()) if "moe_dropped" in ds else 0.0
    # every rank holds the same tokens: the reference's pmean over "model"
    return out.mean(dim=1)[0].numpy(), dropped


@pytest.mark.parametrize("case", ["a2a", "a2a_shared", "replicated", "local",
                                  "a2a_tight"])
def test_moe_block_regimes_match_reference(case):
    E, shared, cf, sharded = 8, 0, 8.0, True
    B_, T = 2, 32                         # B*T = 64: the a2a regime
    if case == "a2a_shared":
        shared = 1
    elif case == "replicated":
        B_, T = 1, 4                      # B*T < tp
    elif case == "local":
        E, sharded = 6, False             # E % ep != 0
    elif case == "a2a_tight":
        cf = 1.0                          # the capacity path drops
    lp = _moe_lp(_moe_cfg(JModelConfig, E, shared, cf))
    x = RNG.randn(B_, T, 32).astype(np.float32)
    want, d_ref = _ref_block(_moe_cfg(JModelConfig, E, shared, cf), lp, x,
                             sharded)
    got, dropped = _port_block(_moe_cfg(ModelConfig, E, shared, cf), lp, x,
                               sharded)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    assert dropped == d_ref
    assert (dropped > 0) == (case == "a2a_tight")


@pytest.mark.parametrize("impl", ["fused", "host"])
def test_moe_block_dropless_impls_match_reference(impl):
    """The tight capacity the a2a path would drop under: the dropless ring
    drops nothing, shared experts included."""
    jcfg, cfg = (_moe_cfg(c, 8, shared=1, cf=1.0)
                 for c in (JModelConfig, ModelConfig))
    lp = _moe_lp(jcfg)
    x = RNG.randn(2, 32, 32).astype(np.float32)
    want, d_ref = _ref_block(jcfg, lp, x, True, dispatch_impl=impl)
    before = fused_moe_dispatch_kernel.launches
    got, dropped = _port_block(cfg, lp, x, True, dispatch_impl=impl)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    assert dropped == d_ref == 0.0
    assert fused_moe_dispatch_kernel.launches == before   # no card here


def test_moe_capacity_equals_reference():
    for args in ((64, 2, 8, 1.0), (64, 2, 8, 1.25), (60, 2, 8, 1.0),
                 (50, 2, 8, 1.0), (7, 2, 4, 1.1), (1, 1, 64, 1.0),
                 (256, 8, 128, 1.25)):
        assert moe_capacity(*args) == j_layers.moe_capacity(*args)


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
    for name, spec in mine.items():
        r = ref[name]
        assert (spec.shape, spec.axes, spec.dtype, spec.init, spec.scale,
                spec.per_expert) == (r.shape, r.axes, r.dtype, r.init,
                                     r.scale, r.per_expert), name
    specs, jspecs = (schema.partition_specs(cfg, MESH),
                     j_sch.partition_specs(jcfg, mesh8))
    for name, spec in specs.items():
        assert spec == _padded(jspecs[name], len(mine[name].shape)), name
    assert cfg.param_count() == jcfg.param_count()


def test_params_round_trip():
    cfg = configs.get_reduced(ARCH)
    ref = {k: _np(v) for k, v in j_sch.init_params(
        j_configs.get_reduced(ARCH), jax.random.PRNGKey(0)).items()}
    mine = params_from_reference(cfg, MESH, ref)
    specs = schema.partition_specs(cfg, MESH)
    assert mine["layers/router"].dtype == torch.float32
    assert mine["layers/w_gate_e"].dtype == torch.bfloat16
    assert specs["layers/w_gate_e"] == (None, "model", "data", None)
    for name, t in mine.items():
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


class _MoE(_Both):
    """Reduced qwen3-moe in both packages under one dispatch_impl."""

    def __init__(self, dt, impl, mesh8):
        super().__init__(ARCH, dt, mesh8)
        self.jctx = JCtx.from_mesh(mesh8, remat=False, inference=True,
                                   dispatch_impl=impl)
        self.ctx = ParallelCtx.from_mesh(MESH, remat=False, inference=True,
                                         dispatch_impl=impl)


IMPLS = ("auto", "fused")


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(impl, mesh8):
    both = _MoE("f32", impl, mesh8)
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
    both = _MoE(dt, impl, mesh8)
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
    both = _MoE(dt, impl, mesh8)
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
    """Three continuous-batching decode steps over a random cache with
    per-slot positions; one built step logs its collectives once."""
    both = _MoE(dt, impl, mesh8)
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


def test_unported_moe_branches_raise():
    """deepseek-v3's loss waits for its MTP term (item 21), as any config
    with MTP does; expert2d placement for item 12."""
    cfg = configs.get_reduced("deepseek-v3-671b")
    ctx = ParallelCtx.from_mesh(MESH)
    with pytest.raises(NotImplementedError, match="item 21"):
        tf.transformer_loss({}, {}, cfg, ctx)
    dense = configs.get_reduced("glm4-9b")
    mtp = type(dense)(**{**{f: getattr(dense, f)
                            for f in dense.__dataclass_fields__},
                         "mtp": True})
    with pytest.raises(NotImplementedError, match="item 21"):
        tf.transformer_loss({}, {}, mtp, ctx)
    with pytest.raises(NotImplementedError, match="item 12"):
        ParallelCtx.from_mesh(MESH, expert2d=True)
