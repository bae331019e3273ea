"""The port's context(seq)-sharded decode held against the JAX package's.

A decode cache sharded over "data" on its S dim keeps the S-chunk
``[r·s_loc, (r+1)·s_loc)`` on data rank r.  ``cp_decode_attention`` runs
each chunk's partial through row 5's kernel (its plain version here) with
the rows' log-sum-exp and merges them with three OMPCCL all-reduces; the
reference computes the chunk's scores in f32 einsums.  Held here:

* ``cp_decode_attention`` and its plain version against the reference's
  inside ``shard_map``, on pod 2 x data 2 x model 2 and data 4 x model 2,
  with a rank whose chunk holds no visible key and ``pos`` on and across a
  chunk boundary: within 1e-5 of the output's scale (f32: both sum in
  f32, in another order); the three all-reduces' call and byte logs equal
  to the reference's;
* the owner-only cache write against the reference's ``_update_cache``,
  bit for bit;
* reduced zamba2-1.2b's 8-token sharded decode from a zero state (the
  reference's ``test_zamba_seq_sharded_decode`` setting: B = 1, S = 16)
  against the reference's sharded step and the port's replicated decode:
  1e-5 of the logits' scale in f32, 2e-2 in bf16 (the reference's own
  bound for this decode);
* a prompt prefilled into a sharded cache, then decoded, and reduced
  glm4-9b's ``transformer_decode(seq_sharded=True)``, the same way;
* the refusals where the reference cannot run: per-slot positions with a
  sharded cache, a prompt longer than ``S / data``, chunked prefill.
"""

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
from repro.core.groups import DiompGroup as JGroup
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ParallelCtx as JCtx
from repro.serve import step as j_step

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.interop import (params_from_reference, stack_shards,
                                 unstack_shards)
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import api, layers, ssm, transformer
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import step as t_step

MESHES = {"pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model")),
          "data4-model2": ((4, 2), ("data", "model"))}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _meshes(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, axis_types="auto"), RankMesh(axes, shape)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


# -- cp_decode_attention on its own ---------------------------------------

def _cp_case(rng, S=32, B=2, H=4, KH=2, D=8, Dv=8):
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k = rng.randn(B, S, KH, D).astype(np.float32)
    v = rng.randn(B, S, KH, Dv).astype(np.float32)
    return q, k, v


def _ref_cp(jmesh, q, k, v, pos):
    group = JGroup(("data",), name="dp_inner")
    jdc = JContext(mesh=jmesh)

    def body(q, k, v):
        cache = j_layers.KVCache(k, v, jnp.asarray(pos, jnp.int32),
                                 seq_sharded=True)
        return j_layers.cp_decode_attention(q, cache, group,
                                            scale=q.shape[-1] ** -0.5)

    f = jax.jit(shard_map(body, mesh=jmesh,
                          in_specs=(P(), P(None, "data"), P(None, "data")),
                          out_specs=P()))
    with j_use_default(jdc):
        out = np.asarray(f(q, k, v))
    return out, jdc


def _port_cp(mesh, q, k, v, pos, fn):
    dc = DiompContext(mesh=mesh, device="cpu")
    kv_spec = (None, "data", None, None)
    cache = layers.KVCache(
        stack_shards(k, mesh, kv_spec), stack_shards(v, mesh, kv_spec),
        torch.full(mesh.sizes, pos, dtype=torch.int32), seq_sharded=True)
    with use_default(dc):
        out = fn(stack_shards(q, mesh, (None,) * 4), cache,
                 DiompGroup(("data",), name="dp_inner"))
    return unstack_shards(out, mesh, (None,) * 4), dc


@pytest.mark.parametrize("pos", [5, 16, 17, 21, 32])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_cp_decode_attention_matches_reference(impl, mesh_name, pos):
    """S = 32 keys over 2 or 4 data ranks (chunks of 16 or 8): pos 5 leaves
    every rank but the first without a visible key; 16 ends exactly on a
    chunk boundary, 17 and 21 cross one, 32 fills the cache."""
    jmesh, mesh = _meshes(mesh_name)
    q, k, v = _cp_case(np.random.RandomState(pos))
    want, jdc = _ref_cp(jmesh, q, k, v, pos)
    fn = layers.cp_decode_attention if impl == "kernel" \
        else layers.cp_decode_attention_plain
    got, dc = _port_cp(mesh, q, k, v, pos, fn)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the three all-reduces: (max, sum) of (B, KH, G) f32, sum of (B, KH,
    # G, Dv) f32, over the data group
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    (calls,) = dc.stats().values()
    assert calls == {"allreduce": 3}


def test_cp_decode_attention_empty_rank_adds_nothing():
    """A rank past ``pos`` enters with weight 0: the result equals plain
    softmax attention over the first ``pos`` keys, whatever finite values
    the invisible rows hold."""
    _, mesh = _meshes("data4-model2")
    q, k, v = _cp_case(np.random.RandomState(7))
    pos = 6
    k[:, pos:], v[:, pos:] = 1e3, -1e3
    got, _ = _port_cp(mesh, q, k, v, pos, layers.cp_decode_attention)
    G = q.shape[2] // k.shape[2]
    kk, vv = np.repeat(k[:, :pos], G, 2), np.repeat(v[:, :pos], G, 2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) * q.shape[-1] ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, vv)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("pos", [0, 7, 8, 15])
def test_update_cache_writes_on_the_owner_only(pos):
    """S = 16 over data 2: the data rank whose chunk holds ``pos`` writes
    the new row at ``pos - r·8``; every other rank keeps its rows, as the
    reference's ``_update_cache`` leaves them, bit for bit."""
    jmesh, mesh = _meshes("pod2-data2-model2")
    rng = np.random.RandomState(pos)
    k = rng.randn(2, 16, 2, 4).astype(np.float32)
    v = rng.randn(2, 16, 2, 4).astype(np.float32)
    kn = rng.randn(2, 1, 2, 4).astype(np.float32)
    vn = rng.randn(2, 1, 2, 4).astype(np.float32)
    group = JGroup(("data",), name="dp_inner")

    def body(k, v, kn, vn):
        c = j_layers._update_cache(
            j_layers.KVCache(k, v, jnp.asarray(pos, jnp.int32),
                             seq_sharded=True), kn, vn, group)
        return c.k, c.v

    spec = P(None, "data")
    jk, jv = jax.jit(shard_map(body, mesh=jmesh,
                               in_specs=(spec, spec, P(), P()),
                               out_specs=(spec, spec)))(k, v, kn, vn)
    tspec = (None, "data", None, None)
    cache = layers.KVCache(stack_shards(k, mesh, tspec),
                           stack_shards(v, mesh, tspec),
                           torch.full(mesh.sizes, pos, dtype=torch.int32),
                           seq_sharded=True)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        new = layers._update_cache(
            cache, stack_shards(kn, mesh, (None,) * 4),
            stack_shards(vn, mesh, (None,) * 4),
            DiompGroup(("data",), name="dp_inner"))
    assert new.seq_sharded and torch.equal(new.pos, cache.pos + 1)
    np.testing.assert_array_equal(unstack_shards(new.k, mesh, tspec),
                                  np.asarray(jk))
    np.testing.assert_array_equal(unstack_shards(new.v, mesh, tspec),
                                  np.asarray(jv))
    changed = np.nonzero((unstack_shards(new.k, mesh, tspec) != k)
                         .any(axis=(0, 2, 3)))[0]
    assert changed.tolist() == [pos]


# -- the model stacks ------------------------------------------------------

class _Model:
    """One reduced arch in both packages on pod 2 x data 2 x model 2, B = 1
    (the batch replicated, the cache's S over "data")."""

    def __init__(self, arch, dt, S):
        self.jmesh, self.mesh = _meshes("pod2-data2-model2")
        self.cfg, self.jcfg = configs.get_reduced(arch), \
            j_configs.get_reduced(arch)
        self.jdt, self.tdt, self.tol = DTYPES[dt]
        self.S = S
        jp = j_sch.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.jp = {k: v.astype(self.jdt) for k, v in jp.items()}
        self.tp = params_from_reference(
            self.cfg, self.mesh, {k: _np(v) for k, v in self.jp.items()},
            dtype=self.tdt)
        self.jctx = JCtx.from_mesh(self.jmesh, remat=False, inference=True)
        self.ctx = ParallelCtx.from_mesh(self.mesh, remat=False,
                                         inference=True)
        self.jdc = JContext(mesh=self.jmesh)
        self.dc = DiompContext(mesh=self.mesh, device="cpu")

    def zero_caches(self, step, seq_sharded):
        """The same zero cache in both packages, laid out by the specs."""
        structs, _ = j_api.cache_structs(self.jcfg, self.jmesh, self.jctx,
                                         1, self.S, seq_sharded=seq_sharded)

        def build(st, spec, j):
            if isinstance(st, dict):
                return {n: build(st[n], spec[n], j) for n in st}
            if st.shape == ():
                return jnp.zeros((), jnp.int32) if j else stack_shards(
                    np.zeros((), np.int32), self.mesh, spec)
            f32 = st.dtype == jnp.float32
            if j:
                return jnp.zeros(st.shape, jnp.float32 if f32 else self.jdt)
            return stack_shards(np.zeros(st.shape, np.float32), self.mesh,
                                spec, dtype=torch.float32 if f32
                                else self.tdt)

        return (build(structs, step.cache_specs, True),
                build(structs, step.cache_specs, False))

    def steps(self, seq_sharded, prefill=False):
        kw = dict(seq_sharded=seq_sharded)
        if prefill:
            return (j_step.build_prefill_step(
                        self.jcfg, self.jmesh, self.jctx, B=1, S_prompt=6,
                        S_cache=self.S, donate=False, **kw),
                    t_step.build_prefill_step(self.cfg, self.mesh, self.ctx,
                                              B=1, S_cache=self.S, **kw))
        return (j_step.build_decode_step(self.jcfg, self.jmesh, self.jctx,
                                         B=1, S=self.S, donate=False, **kw),
                t_step.build_decode_step(self.cfg, self.mesh, self.ctx, B=1,
                                         S=self.S, **kw))

    def run(self, toks, seq_sharded, prompt=None):
        """Greedy-free decode of ``toks (1, n)`` (after ``prompt`` when
        given) in both packages; returns (reference logits, port logits),
        each ``(n, V)``, and the last caches."""
        jdec, tdec = self.steps(seq_sharded)
        jc, tc = self.zero_caches(tdec, seq_sharded)
        jl_all, tl_all = [], []
        if prompt is not None:
            jpre, tpre = self.steps(seq_sharded, prefill=True)
            with j_use_default(self.jdc):
                jl, jc = jpre(self.jp, prompt, jc)
            with use_default(self.dc):
                tl, tc = tpre(self.tp, stack_shards(
                    prompt, self.mesh, tpre.token_spec), tc)
            jl_all.append(np.asarray(jl, np.float32)[0, -1])
            tl_all.append(unstack_shards(tl, self.mesh,
                                         tpre.logits_spec)[0, -1])
        for i in range(toks.shape[1]):
            t = toks[:, i:i + 1]
            with j_use_default(self.jdc):
                jl, jc = jdec(self.jp, t, jc)
            with use_default(self.dc):
                tl, tc = tdec(self.tp, stack_shards(t, self.mesh,
                                                    tdec.token_spec), tc)
            jl_all.append(np.asarray(jl, np.float32)[0, 0])
            tl_all.append(unstack_shards(tl, self.mesh,
                                         tdec.logits_spec)[0, 0])
        return np.stack(jl_all), np.stack(tl_all), jc, tc, tdec


def _close(got, want, tol):
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_zamba_seq_sharded_decode_matches_reference(dt):
    """The reference's ``test_zamba_seq_sharded_decode`` setting: reduced
    zamba2-1.2b, B = 1, S = 16 over data 2, 8 decode steps from a zero
    state; the K/V rows each step leaves must equal the reference's too."""
    m = _Model("zamba2-1-2b", dt, 16)
    toks = np.random.RandomState(6).randint(
        0, m.cfg.vocab_size, (1, 8)).astype(np.int32)
    j_sh, t_sh, jc, tc, tdec = m.run(toks, True)
    _, t_rep, *_ = m.run(toks, False)
    _close(t_sh, j_sh, m.tol)
    _close(t_sh, t_rep, m.tol)
    assert tdec.cache_specs["k"][2] == "data"
    for name in ("k", "v"):
        w = _np(jc[name])
        g = unstack_shards(tc[name], m.mesh, tdec.cache_specs[name])
        assert np.abs(g - w).max() <= m.tol * max(np.abs(w).max(), 1)
    assert int(tc["pos"].reshape(-1)[0]) == 8


@pytest.mark.parametrize("arch", ["zamba2-1-2b", "glm4-9b"])
def test_prompt_into_sharded_cache_then_decode(arch):
    """A 6-token prompt prefilled into a sharded cache of 16 rows over data
    2 (it lands at local row 0 on both ranks), then 5 decode steps that
    cross into the second rank's chunk at position 8: against the
    reference's sharded steps and the port's replicated ones (f32)."""
    m = _Model(arch, "f32", 16)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, m.cfg.vocab_size, (1, 6)).astype(np.int32)
    toks = rng.randint(0, m.cfg.vocab_size, (1, 5)).astype(np.int32)
    j_sh, t_sh, *_ = m.run(toks, True, prompt=prompt)
    _, t_rep, *_ = m.run(toks, False, prompt=prompt)
    _close(t_sh, j_sh, m.tol)
    _close(t_sh, t_rep, m.tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_glm4_transformer_decode_seq_sharded_matches_reference(dt):
    """Reduced glm4-9b (GQA with replicated KV weights, head-sharded
    cache): 10 decode steps over S = 16 sharded over data 2, through the
    built steps, and the call/byte logs of one traced step."""
    m = _Model("glm4-9b", dt, 16)
    toks = np.random.RandomState(5).randint(
        0, m.cfg.vocab_size, (1, 10)).astype(np.int32)
    j_sh, t_sh, *_ = m.run(toks, True)
    _, t_rep, *_ = m.run(toks, False)
    _close(t_sh, j_sh, m.tol)
    _close(t_sh, t_rep, m.tol)
    # one trace of the reference's sharded step against one call of the
    # port's: the cp attention's three all-reduces over "data" included
    m.jdc, m.dc = JContext(mesh=m.jmesh), DiompContext(mesh=m.mesh,
                                                       device="cpu")
    jdec, tdec = m.steps(True)
    jc, tc = m.zero_caches(tdec, True)
    with j_use_default(m.jdc):
        jax.eval_shape(jdec, m.jp, toks[:, :1], jc)
    with use_default(m.dc):
        tdec(m.tp, stack_shards(toks[:, :1], m.mesh, tdec.token_spec), tc)
    assert m.dc.stats() == m.jdc.stats()
    assert m.dc.byte_stats() == m.jdc.byte_stats()
    assert m.dc.stats()[DiompGroup(("data",), name="dp_inner")
                        .descriptor()]["allreduce"] == 3


def test_cache_structs_seq_sharded_equal_reference():
    jmesh, mesh = _meshes("pod2-data2-model2")
    for arch in ("glm4-9b", "zamba2-1-2b", "stablelm-3b"):
        cfg, jcfg = configs.get_reduced(arch), j_configs.get_reduced(arch)
        ctx = ParallelCtx.from_mesh(mesh, inference=True)
        jctx = JCtx.from_mesh(jmesh, inference=True)
        structs, specs = api.cache_structs(cfg, mesh, ctx, 1, 32,
                                           seq_sharded=True)
        jstructs, jspecs = j_api.cache_structs(jcfg, jmesh, jctx, 1, 32,
                                               seq_sharded=True)
        for n in ("k", "v"):
            assert structs[n].shape == jstructs[n].shape
            parts = list(jspecs[n]) + [None] * (5 - len(jspecs[n]))
            assert specs[n] == tuple(parts), (arch, n)
            assert specs[n][2] == "data"


def test_init_caches_hold_a_chunk_a_rank():
    _, mesh = _meshes("pod2-data2-model2")
    ctx = ParallelCtx.from_mesh(mesh, inference=True)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        c = transformer.init_cache(configs.get_reduced("glm4-9b"), ctx, 1,
                                   32, seq_sharded=True, device="cpu")
        z = ssm.zamba_init_state(configs.get_reduced("zamba2-1-2b"), ctx, 1,
                                 32, seq_sharded=True, device="cpu")
    assert c["k"].shape[mesh.ndim + 2] == 16
    assert z["k"].shape[mesh.ndim + 2] == 16


def test_refusals_where_the_reference_cannot_run():
    m = _Model("glm4-9b", "f32", 16)
    # per-slot positions with a sharded cache
    ts = t_step.build_decode_step(m.cfg, m.mesh, m.ctx, B=1, S=16,
                                  seq_sharded=True, slot_pos=True)
    _, tc = m.zero_caches(m.steps(True)[1], True)
    tc["pos"] = torch.zeros(*m.mesh.sizes, 1, dtype=torch.int32)
    toks = stack_shards(np.zeros((1, 1), np.int32), m.mesh, ts.token_spec)
    with use_default(m.dc), pytest.raises(ValueError, match="per-slot"):
        ts(m.tp, toks, tc)
    # a prompt longer than S / data
    pre = t_step.build_prefill_step(m.cfg, m.mesh, m.ctx, B=1, S_cache=16,
                                    seq_sharded=True)
    _, tc = m.zero_caches(pre, True)
    long = stack_shards(np.zeros((1, 9), np.int32), m.mesh, pre.token_spec)
    with use_default(m.dc), pytest.raises(ValueError, match="S / data"):
        pre(m.tp, long, tc)
    # chunked prefill into a sharded cache
    with use_default(m.dc), pytest.raises(ValueError, match="seq_sharded"):
        transformer.transformer_chunk_prefill(m.tp, long, m.cfg, m.ctx, tc,
                                              9, seq_sharded=True)
