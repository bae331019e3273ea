"""The port's audio family (hubert-xlarge) held against the JAX package's.

hubert-xlarge is an encoder: frame embeddings in (the conv frontend is a
stub in both packages), a LayerNorm by ``embed_norm``, sinusoidal
positions, non-causal attention, a plain GELU MLP (jax's default tanh
form), and the masked-frame cross-entropy against ``head``.  Reduced
hubert runs on the 8-rank smoke mesh (pod 2 x data 2 x model 2, the
reference's ``mesh8``).  Held here: the schema, placement specs and
parameter count; the weights carried over exactly; the encoder's hidden
states under inference; the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss in a test-built
``shard_map`` (the reference's ``build_train_step`` fails under jax
0.9); GELU's form and the sinusoid; the launcher on the CPU; and the
encoder's refusal of every serve step.  Tolerances: f32 hidden states and
loss 1e-5 relative, gradients 1e-4 of each leaf's largest value (f32 sums
in another order); bf16 2e-2 (hidden states), 1e-3 (loss) and 2e-2
(gradients), the model stack's bf16 bounds.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.core import ompccl as j_ompccl
from repro.core.compat import shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import buckets as j_bk
from repro.distributed.sharding import rules_for_ctx as j_rules_for_ctx
from repro.models import api as j_api
from repro.models import schema as j_sch
from repro.models import transformer as j_tf
from repro.models.config import ParallelCtx as JCtx

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.sharding import rules_for_ctx
from repro_torch.interop import (local_shape, params_from_reference,
                                 stack_shards, unstack_shards)
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import api, schema, transformer
from repro_torch.models.config import ParallelCtx
from repro_torch.serve import step as t_step
from repro_torch.train.step import per_rank_grads, reduce_gradients

ARCH = "hubert-xlarge"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-3, 2e-2)}
B, S = 8, 16
MESH = make_smoke_mesh(8)


def _padded(spec, ndim):
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(p) if isinstance(p, list) else p for p in parts)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def ref_params(arch, dt):
    """The reference's reduced weights in ``dt`` (numpy, global view)."""
    jcfg = j_configs.get_reduced(arch)
    return {k: v.astype(DTYPES[dt][0]) for k, v in
            j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}


def pipeline_batch(cfg, step=0):
    """The data pipeline's batch (audio: frames, targets, a 0/1 mask)."""
    return SyntheticLM(cfg, B, S, seed=17).batch_at(step)


def _cast(batch, jdt):
    return {k: jnp.asarray(v).astype(jdt) if v.dtype == np.float32
            and k != "mask" else jnp.asarray(v) for k, v in batch.items()}


def reference_grads(arch, dt, mesh8, batch, **knobs):
    """The reference's mean loss and DP-reduced gradients (global view):
    ``jax.value_and_grad`` of its ``loss_fn`` in a ``shard_map`` with the
    parameters made varying over the DP axes, each gradient divided by dp
    and summed over its unreduced DP axes (``reduce_gradients``'
    contract), under the placement rules of ``knobs``' layout.

    What is differentiated is the mean of the loss's replicas over the
    non-DP axes, the loss a step reports.  With a vocabulary too small to
    shard (hubert's 504), the reference's CE is typed as varying over
    "model" though its replicas are equal, and differentiating each
    replica as the reference's own step does counts the loss ``tp`` times
    (every gradient ``tp``-fold); the replicas' mean counts it once, as
    the port's step does."""
    jcfg = j_configs.get_reduced(arch)
    jp = ref_params(arch, dt)
    jctx = JCtx.from_mesh(mesh8, remat=True, **knobs)
    pspecs = j_sch.partition_specs(jcfg, mesh8, j_rules_for_ctx(jctx))
    _, bspecs = j_api.batch_structs(jcfg, mesh8, B, S,
                                    dp_axes=jctx.dp_group.axes)
    dp = jctx.dp_group.axes
    rep = tuple(a for a in mesh8.axis_names if a not in dp)
    loss_fn = j_api.loss_fn(jcfg)

    def mean_loss(p, batch):
        loss = loss_fn(p, batch, jcfg, jctx)
        return lax.pmean(loss, rep) if rep else loss

    def body(params, batch):
        p = j_ompccl.ensure_varying(params, dp)
        loss, g = jax.value_and_grad(lambda p: mean_loss(p, batch))(p)
        out = {}
        for n, v in g.items():
            need = j_bk.unreduced_dp_axes(pspecs[n], dp)
            v = v.astype(jnp.float32) / jctx.dp
            out[n] = lax.psum(v, need) if need else v
        return lax.pmean(loss, dp), out

    f = shard_map(body, mesh=mesh8, in_specs=(pspecs, bspecs),
                  out_specs=(P(), pspecs))
    with j_use_default(JContext(mesh=mesh8)):
        loss, grads = jax.jit(f)(jp, _cast(batch, DTYPES[dt][0]))
    return jp, float(loss), {n: _np(g) for n, g in grads.items()}


def port_grads(arch, dt, jp, batch, **knobs):
    """The port's mean loss and reduced gradients (global view) on the
    reference's weights and the same batch."""
    cfg = configs.get_reduced(arch)
    ctx = ParallelCtx.from_mesh(MESH, remat=True, **knobs)
    rules = rules_for_ctx(ctx)
    tdt = DTYPES[dt][1]
    tp = params_from_reference(cfg, MESH, {k: _np(v) for k, v in jp.items()},
                               dtype=tdt, rules=rules)
    structs, bspecs = api.batch_structs(cfg, MESH, B, S, dp_axes=ctx.dp_axes)
    tb = {k: stack_shards(v, MESH, bspecs[k],
                          dtype=tdt if structs[k].dtype == torch.bfloat16
                          else structs[k].dtype)
          for k, v in batch.items()}
    specs = schema.partition_specs(cfg, MESH, rules)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        loss, grads = per_rank_grads(tp, tb, cfg, ctx, MESH, pspecs=specs)
        red, _ = reduce_gradients(grads, cfg, ctx, pspecs=specs, mesh=MESH)
    return (float(loss.mean()),
            {n: unstack_shards(g, MESH, specs[n]) for n, g in red.items()})


def assert_grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(got[n] - w).max() <= tol * scale, n


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_schema_and_specs_equal_reference(full, mesh8):
    get = (configs.get, j_configs.get) if full else \
        (configs.get_reduced, j_configs.get_reduced)
    cfg, jcfg = get[0](ARCH), get[1](ARCH)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    mine, ref = schema.build_schema(cfg), j_sch.build_schema(jcfg)
    assert sorted(mine) == sorted(ref)
    assert {"embed_norm", "head"} <= set(mine) and "lm_head" not in mine
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


def test_full_config_parameter_count_in_the_reference_band():
    """The reference's published band for hubert-xlarge
    (``tests/test_system.py``), and its exact count."""
    n = configs.get(ARCH).param_count()
    assert 0.8e9 <= n <= 1.6e9
    assert n == j_configs.get(ARCH).param_count()
    assert "hubert-xlarge" in configs.all_archs()
    assert len(configs.ARCHS) == len(j_configs.ARCHS) == 10
    assert sorted(configs.ARCHS) == sorted(j_configs.ARCHS)


def test_params_round_trip():
    cfg = configs.get_reduced(ARCH)
    ref = {k: _np(v) for k, v in ref_params(ARCH, "bf16").items()}
    mine = params_from_reference(cfg, MESH, ref)
    specs = schema.partition_specs(cfg, MESH)
    for name, t in mine.items():
        assert t.dtype == torch.bfloat16
        assert tuple(t.shape) == local_shape(ref[name].shape, MESH,
                                             specs[name])
        np.testing.assert_array_equal(unstack_shards(t, MESH, specs[name]),
                                      ref[name])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_encoder_hidden_states_match_reference(dt, mesh8):
    """The encoder's "prefill": the forward over the frames under an
    inference context, as the reference's dry run lowers it."""
    jdt, tdt, tol = DTYPES[dt][:3]
    jcfg, cfg = j_configs.get_reduced(ARCH), configs.get_reduced(ARCH)
    jp = ref_params(ARCH, dt)
    frames = pipeline_batch(cfg)["embeds"]
    jctx = JCtx.from_mesh(mesh8, remat=False, inference=True)
    pspecs = j_sch.partition_specs(jcfg, mesh8)
    ba = j_api._batch_axes(mesh8, B)

    def enc(params, x):
        return j_tf.transformer_forward(params, None, jcfg, jctx,
                                        embeds=x)[0]

    with j_use_default(JContext(mesh=mesh8)):
        want = _np(jax.jit(shard_map(
            enc, mesh=mesh8, in_specs=(pspecs, P(ba)),
            out_specs=P(ba)))(jp, jnp.asarray(frames).astype(jdt)))
    ctx = ParallelCtx.from_mesh(MESH, remat=False, inference=True)
    tp = params_from_reference(cfg, MESH, {k: _np(v) for k, v in jp.items()},
                               dtype=tdt)
    spec = (ba, None, None)
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        h, cache = transformer.transformer_forward(
            tp, None, cfg, ctx,
            embeds=stack_shards(frames, MESH, spec, dtype=tdt))
    got = unstack_shards(h, MESH, spec)
    assert cache is None and got.shape == want.shape == (B, S, cfg.d_model)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_masked_frame_loss_and_gradients_match_reference(dt, mesh8):
    """The loss (the CE weighted by the frame mask) and every gradient leaf,
    the unused ``w_gate`` (zero in both) and the data-sharded ``head``
    included; the backward runs flash attention's gradient non-causally."""
    _, _, _, ltol, gtol = DTYPES[dt]
    batch = pipeline_batch(configs.get_reduced(ARCH))
    jp, jloss, jgrads = reference_grads(ARCH, dt, mesh8, batch)
    loss, grads = port_grads(ARCH, dt, jp, batch)
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= ltol * abs(jloss)
    assert_grads_close(grads, jgrads, gtol)
    assert not np.any(grads["layers/w_gate"])
    assert np.any(grads["head"]) and np.any(grads["embed_norm"])


def test_gelu_is_the_tanh_form_and_the_sinusoid_is_the_reference():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's GELU
    MLP uses it (the exact erf form differs by up to 1e-3 here).  The
    sinusoid (sin on even columns, cos on odd) equals the reference's in
    f32 and after its cast to bf16."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    for T, d in ((37, 64), (16, 1280)):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            w = _np(j_tf._sinusoid(T, d, jdt))
            g = transformer._sinusoid(T, d, tdt, "cpu").float().numpy()
            assert g.shape == (T, d)
            np.testing.assert_allclose(g, w, atol=2e-6 if
                                       tdt == torch.float32 else 1e-2)


def test_synthetic_audio_batches_equal_reference():
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    for step in (0, 5):
        got = SyntheticLM(cfg, 4, 24, seed=17, shard=1).batch_at(step)
        want = JSyntheticLM(jcfg, 4, 24, seed=17, shard=1).batch_at(step)
        assert sorted(got) == sorted(want) == ["embeds", "mask", "targets"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_batch_and_cache_structs_equal_reference(mesh8):
    cfg, jcfg = configs.get_reduced(ARCH), j_configs.get_reduced(ARCH)
    structs, specs = api.batch_structs(cfg, MESH, B, S)
    jstructs, jspecs = j_api.batch_structs(jcfg, mesh8, B, S)
    for k, st in structs.items():
        assert st.shape == jstructs[k].shape
        assert specs[k] == _padded(jspecs[k], len(st.shape))
    ctx = ParallelCtx.from_mesh(MESH, inference=True)
    jctx = JCtx.from_mesh(mesh8, inference=True)
    cs, csp = api.cache_structs(cfg, MESH, ctx, B, S)
    jcs, jcsp = j_api.cache_structs(jcfg, mesh8, jctx, B, S)
    assert sorted(cs) == sorted(jcs)
    for k in ("k", "v"):
        assert cs[k].shape == jcs[k].shape
        assert csp[k] == _padded(jcsp[k], 5)
    assert api.loss_fn(cfg) is transformer.transformer_loss
    assert not api.has_decode(cfg) and not j_api.has_decode(jcfg)


def test_the_encoder_has_no_serve_step():
    cfg = configs.get_reduced(ARCH)
    ctx = ParallelCtx.from_mesh(MESH, inference=True)
    for build, kw in ((t_step.build_decode_step, {"B": B, "S": S}),
                      (t_step.build_prefill_step, {"B": B, "S_cache": S}),
                      (t_step.build_chunk_prefill_step,
                       {"C": 8, "S_cache": S})):
        with pytest.raises(ValueError, match="encoder"):
            build(cfg, MESH, ctx, **kw)
    from repro_torch.launch import serve as serve_launcher
    with pytest.raises(SystemExit):
        serve_launcher.main(["--device", "cpu", "--arch", ARCH])


def test_launcher_trains_hubert_on_the_cpu(monkeypatch):
    """``launch.train --arch hubert-xlarge --reduced --device cpu`` on the
    pipeline's audio batches (frames laid out in bf16, as ``batch_structs``
    declares them).  Every step draws the first batch, so the loss falls."""
    from repro_torch.core.context import reset_default_context
    from repro_torch.launch import train as launcher

    first = SyntheticLM.batch_at
    monkeypatch.setattr(SyntheticLM, "batch_at",
                        lambda self, step: first(self, 0))
    seen = []
    real = launcher._batch_on

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(launcher, "_batch_on", spy)
    try:
        run = launcher.main(["--arch", ARCH, "--reduced", "--steps", "6",
                             "--batch", "8", "--seq", "16", "--lr", "5e-3",
                             "--device", "cpu"])
    finally:
        reset_default_context()
    assert all(np.isfinite(run["losses"] + run["grad_norms"]))
    assert run["losses"][-1] < run["losses"][0] - 0.05, run["losses"]
    assert seen[0]["embeds"].dtype == torch.bfloat16
    assert seen[0]["mask"].dtype == torch.float32
