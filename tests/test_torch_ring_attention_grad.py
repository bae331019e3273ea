"""The port's ring-attention gradient held against the JAX package's.

The same inputs, made from a seed with numpy, go through both packages on
the CPU:

* the VJP pieces (``finalize_bwd``, ``merge_bwd``, ``stripe_bwd``,
  ``chain_grads``) against the reference's numpy callbacks, within 1e-5 of
  each cotangent's largest magnitude (the port's products run in float64
  rounded once, the reference's in float32);
* the port's ``ring_attention_ref`` differentiated by autograd (its
  hand-written VJP) against ``jax.vjp`` of the reference's oracle, at the
  forward tests' ``_close`` bounds;
* the emulation's gradient, ``host`` and ``fused``, equal to the port's
  oracle bit for bit on a one-axis and a two-axis mesh, and within
  ``_close``'s bounds of the reference's emulation differentiated under
  ``shard_map`` with ``check_vma=False`` (jax 0.9's varying-axes check
  rejects the reference's own gradient test);
* the books: the communicator's call and byte logs and the tracker's
  windows after a forward and a backward equal those after the forward;
* ``attention_block`` under ``seq_parallel="ring"``: the gradients of x
  and of the weights against the port's ``"allgather"`` and against the
  reference's ``jax.grad`` of the same block under ``"allgather"`` (8
  heads on 2 kv heads, d 64, model 4 x data 1, f32; the reference's ring
  branch does not differentiate on jax 0.9);
* the kernel wrapper's CPU path and the C entry's ABI; on the card,
  ``chip_smoke.check_ring_attention_bwd``.
"""

import copy
import dataclasses
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.kernels.ring_attention import kernel as jk
from repro.kernels.ring_attention import ring_attention as j_ring_attention
from repro.kernels.ring_attention import ring_attention_ref as j_ring_ref
from repro.models import layers as j_layers
from repro.models import schema as j_sch
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ParallelCtx as JCtx

from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import params_from_reference, stack_shards, \
    unstack_shards
from repro_torch.kernels import _build, plan
from repro_torch.kernels.ring_attention import (kernel as tk, ring_attention,
                                                ring_attention_ref)
from repro_torch.kernels.ring_attention import fused
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, ParallelCtx

from test_torch_ring_attention import (CASES, GROUP, JGROUP, REPL, SEQ,
                                       _bf16, _case, _chunk_case, _close, _j,
                                       _t)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _np(x):
    return np.asarray(x, np.float32)


def _near(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


# -- the VJP pieces ----------------------------------------------------------------

def _stripe_inputs(seed, B=2, tq=5, tk=6, KH=2, G=2, D=8, Dv=4, causal=True,
                   empty_rows=True):
    rng = np.random.RandomState(seed)
    qg = rng.randn(B, tq, KH, G, D).astype(np.float32)
    k = rng.randn(B, tk, KH, D).astype(np.float32)
    v = rng.randn(B, tk, KH, Dv).astype(np.float32)
    q_pos = np.arange(tq)[None] + (0 if empty_rows else tk)
    vis = np.ones((B, tq, tk), bool)
    if causal:
        vis &= np.arange(tk)[None, None] <= q_pos[:, :, None] - 2
    gl = rng.randn(B, tq, KH, G).astype(np.float32)
    gacc = rng.randn(B, tq, KH, G, Dv).astype(np.float32)
    return qg, k, v, vis, gl, gacc


@pytest.mark.parametrize("causal", [True, False])
def test_stripe_bwd_equals_reference(causal):
    qg, k, v, vis, gl, gacc = _stripe_inputs(0, causal=causal)
    want = jk.stripe_bwd(*map(jnp.asarray, (qg, k, v, vis, gl, gacc)))
    got = tk.stripe_bwd(*map(torch.tensor, (qg, k, v, vis, gl, gacc)))
    for a, b in zip(got, want):
        _near(a, b)
    if causal:                 # rows 0 and 1 see no key: their dq is 0
        assert not got[0][:, :2].any()


def test_finalize_and_merge_bwd_equal_reference():
    rng = np.random.RandomState(1)
    l = np.abs(rng.randn(2, 3, 2, 2)).astype(np.float32)
    l[0, 0] = 0.0                               # dead rows
    acc = rng.randn(2, 3, 2, 2, 4).astype(np.float32)
    ct = rng.randn(2, 3, 2, 2, 4).astype(np.float32)
    want = jk.finalize_bwd(*map(jnp.asarray, (ct, l, acc)))
    got = tk.finalize_bwd(*map(torch.tensor, (ct, l, acc)))
    for a, b in zip(got, want):
        _near(a, b)
    assert not got[0][0, 0].any()               # gl is 0 on dead rows
    m1 = rng.randn(2, 3, 2, 2).astype(np.float32)
    m2 = rng.randn(2, 3, 2, 2).astype(np.float32)
    m1[0, 0] = -np.inf                          # empty left side
    m2[1, 1] = -np.inf                          # empty right side
    m1[1, 2] = m2[1, 2] = -np.inf               # both empty
    gl = rng.randn(2, 3, 2, 2).astype(np.float32)
    gl[1, 1, 0, 0] = -0.0
    gacc = rng.randn(2, 3, 2, 2, 4).astype(np.float32)
    want = jk.merge_bwd(*map(jnp.asarray, (m1, m2, gl, gacc)))
    got = tk.merge_bwd(*map(torch.tensor, (m1, m2, gl, gacc)))
    for a, b in zip(got, want):
        _near(a, b)
    # an empty side passes the other's cotangent through verbatim
    assert torch.equal(got[0][1, 1], torch.tensor(gl[1, 1]))
    assert torch.equal(torch.signbit(got[0][1, 1]),
                       torch.signbit(torch.tensor(gl[1, 1])))
    assert torch.equal(got[3][0, 0], torch.tensor(gacc[0, 0]))


@pytest.mark.parametrize("name", ["n2_causal", "n4_bidi", "n4_mqa", "n4_mha",
                                  "n4_dv_ne_d", "n1", "n8_causal"])
def test_chain_grads_equal_reference(name):
    """Rank 1's (or 0's) fold chain: the stripes in its schedule order,
    their masks from the plan; the query cotangent summed in fold order and
    each stripe's K/V cotangents against the reference's chain."""
    n, ckw, kw, _ = CASES[name]
    q, k, v = _case(n, **ckw)
    B, T, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[-1]
    tq = T // n
    p = plan.AttentionRingPlan(n=n, tq_loc=tq, tk_loc=tq, h=H, kh=KH, d=D,
                               dv=Dv, b=B, causal=kw.get("causal", True))
    r = min(1, n - 1)
    q_pos = np.arange(r * tq, (r + 1) * tq)
    ct = np.random.RandomState(3).randn(B, tq, KH, H // KH, Dv).astype(
        np.float32)
    stripes = []
    for src in p.sources(r):
        kp = np.arange(src * tq, (src + 1) * tq)
        vis = np.broadcast_to(
            (kp[None, :] <= q_pos[:, None]) if p.causal
            else np.ones((tq, tq), bool), (B, tq, tq))
        stripes.append((k[:, src * tq:(src + 1) * tq],
                        v[:, src * tq:(src + 1) * tq], vis))
    qg = (q[:, r * tq:(r + 1) * tq] * D ** -0.5).reshape(B, tq, KH, -1, D)
    want = jk.chain_grads(jnp.asarray(qg), [tuple(map(jnp.asarray, s))
                                            for s in stripes],
                          jnp.asarray(ct))
    got = tk.chain_grads(torch.tensor(qg), [tuple(map(torch.tensor, s))
                                            for s in stripes],
                         torch.tensor(ct))
    _near(got[0], want[0])
    for i in range(len(stripes)):
        _near(got[1][i], want[1][i])
        _near(got[2][i], want[2][i])


# -- the oracle's gradient against the reference's -------------------------------

ORACLE_CASES = {
    # name: (case kwargs or chunk, call kwargs, bf16)
    "train_causal": (dict(n=4), dict(causal=True), False),
    "train_bidi": (dict(n=4), dict(causal=False), False),
    "train_gqa8": (dict(n=3, H=8, KH=1), {}, False),
    "train_dv_ne_d": (dict(n=4, DV=4), {}, False),
    "train_padded": (dict(n=4, tq=6), dict(valid_len=20), False),
    "train_bf16": (dict(n=4), {}, True),
    "train_padded_bf16": (dict(n=3, H=8, KH=1), dict(valid_len=10), True),
    "chunk": ("chunk", dict(causal=True, q_sharded=False), False),
    "chunk_bidi": ("chunk", dict(causal=False, q_sharded=False), False),
}


def _oracle_inputs(name):
    ckw, kw, bf16 = ORACLE_CASES[name]
    if ckw == "chunk":
        q, k, v, p0, tq = _chunk_case(3)
        kw = dict(kw, n=3, q_offset=p0, valid_len=p0 + tq)
    else:
        ckw = dict(ckw)
        n = ckw.pop("n")
        q, k, v = _case(n, **ckw)
        kw = dict(kw, n=n)
    if bf16:
        q, k, v = (_bf16(a) for a in (q, k, v))
    ct = np.random.RandomState(9).randn(*q.shape[:-1], v.shape[-1]).astype(
        np.float32)
    return q, k, v, ct, kw, bf16


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_grad_matches_reference_vjp(name):
    q, k, v, ct, kw, bf16 = _oracle_inputs(name)
    _, vjp = jax.vjp(lambda a, b, c: j_ring_ref(a, b, c, **kw),
                     *(_j(a, bf16) for a in (q, k, v)))
    want = vjp(_j(ct, bf16))
    args = [_t(a, bf16).requires_grad_() for a in (q, k, v)]
    out = ring_attention_ref(*args, **kw)
    got = torch.autograd.grad(out, args, _t(ct, bf16))
    for a, b in zip(got, want):
        assert a.dtype == args[0].dtype
        _close(a.float().numpy(), np.asarray(b, np.float32), bf16)


# -- the emulation's gradient: bit for bit with the oracle ---------------------

def _books(dc):
    return copy.deepcopy((dc.stats(), dc.byte_stats(), dc.rma.window_bytes,
                          dc.rma.put_bytes))


def _port_grads(q, k, v, ct, n, spec, *, mesh=None, impl="fused", **kw):
    """The emulation's output and gradients through ``ring_attention`` on
    stacked ranks; the books after the forward and after the backward."""
    mesh = mesh or RankMesh(("x",), (n,))
    dc = DiompContext(mesh=mesh, device="cpu")
    with use_default(dc):
        args = [stack_shards(a, mesh, s).requires_grad_()
                for a, s in ((q, spec), (k, SEQ), (v, SEQ))]
        out = ring_attention(*args, GROUP, impl=impl, **kw)
        after_fwd = _books(dc)
        got = torch.autograd.grad(out, args, stack_shards(ct, mesh, spec))
        after_bwd = _books(dc)
    return out, got, mesh, after_fwd, after_bwd


@pytest.mark.parametrize("impl", ["host", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_grad_bit_equal_oracle(name, impl):
    n, ckw, kw, bf16 = CASES[name]
    q, k, v = (_bf16(a) if bf16 else a for a in _case(n, **ckw))
    ct = np.random.RandomState(4).randn(*q.shape[:-1], v.shape[-1]).astype(
        np.float32)
    if bf16:
        ct = _bf16(ct)
    dt = torch.bfloat16 if bf16 else torch.float32
    args = [torch.tensor(a, dtype=dt).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ring_attention_ref(*args, n=n, **kw), args,
                               torch.tensor(ct, dtype=dt))
    _, got, mesh, books_fwd, books_bwd = _port_grads(
        *(torch.tensor(a, dtype=dt) for a in (q, k, v, ct)), n, SEQ,
        impl=impl, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dt
        assert torch.equal(torch.tensor(unstack_shards(a, mesh, SEQ)),
                           b.float()), name
    assert books_bwd == books_fwd            # the backward logs nothing


@pytest.mark.parametrize("impl", ["host", "fused"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_emulation_grad_chunk_layout_bit_equal_oracle(n, impl):
    """Shared queries (``q_sharded=False``) over striped keys: with the
    cotangent on rank 0 alone (the oracle replays rank 0's fold order and
    has one set of queries), rank 0's dq and every rank's dk, dv equal the
    oracle's; with it on every rank, dk and dv are the sum of every rank's
    share (each rank's queries are an input of their own)."""
    q, k, v, p0, tq = _chunk_case(n)
    kw = dict(causal=True, q_offset=p0, valid_len=p0 + tq, q_sharded=False)
    ct = np.random.RandomState(5).randn(*q.shape[:-1], v.shape[-1]).astype(
        np.float32)
    args = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ring_attention_ref(*args, n=n, **kw), args,
                               torch.tensor(ct))
    mesh = RankMesh(("x",), (n,))
    ct_st = torch.zeros(n, *ct.shape)
    ct_st[0] = torch.tensor(ct)
    dc = DiompContext(mesh=mesh, device="cpu")
    with use_default(dc):
        st = [stack_shards(q, mesh, REPL).requires_grad_()] + [
            stack_shards(a, mesh, SEQ).requires_grad_() for a in (k, v)]
        out = ring_attention(*st, GROUP, impl=impl, **kw)
        got = torch.autograd.grad(out, st, ct_st)
    assert torch.equal(got[0][0], want[0])
    assert not got[0][1:].any()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(torch.tensor(unstack_shards(a, mesh, SEQ)), b)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        out = ring_attention(*st, GROUP, impl=impl, **kw)
        full = torch.autograd.grad(out, st, torch.tensor(ct).expand(
            n, *ct.shape))
    for a, b in zip(full[1:], want[1:]):
        _close(unstack_shards(a, mesh, SEQ), n * b.numpy(), False)


def test_emulation_grad_bit_equal_on_a_two_axis_mesh():
    """The ring is one axis of a (data 2, x 3) mesh: each data row is an
    independent ring, and its gradients equal the oracle's bit for bit."""
    n, B = 3, 2
    q, k, v = _case(n, B=2 * B, H=8, KH=1, seed=4)
    ct = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    mesh = RankMesh(("data", "x"), (2, n))
    spec = ("data", "x", None, None)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        st = [stack_shards(a, mesh, spec).requires_grad_() for a in (q, k, v)]
        got = torch.autograd.grad(ring_attention(*st, GROUP, causal=True),
                                  st, stack_shards(ct, mesh, spec))
    got = [torch.tensor(unstack_shards(a, mesh, spec)) for a in got]
    for d in range(2):
        rows = slice(d * B, (d + 1) * B)
        args = [torch.tensor(a[rows]).requires_grad_() for a in (q, k, v)]
        want = torch.autograd.grad(ring_attention_ref(*args, n=n), args,
                                   torch.tensor(ct[rows]))
        for a, b in zip(got, want):
            assert torch.equal(a[rows], b)


@pytest.mark.parametrize("impl", ["host", "fused"])
@pytest.mark.parametrize("name", ["n2_causal", "n4_bidi", "n4_mqa",
                                  "n4_dv_ne_d", "n4_padded", "n1"])
def test_emulation_grad_matches_reference_shard_map(name, impl):
    """The reference's emulation differentiated under ``shard_map`` (its
    hand-written ``ring_bwd``; ``check_vma=False``)."""
    n, ckw, kw, _ = CASES[name]
    q, k, v = _case(n, **ckw)
    ct = np.random.RandomState(7).randn(*q.shape[:-1], v.shape[-1]).astype(
        np.float32)
    spec = P(None, "x")

    def g(q, k, v, ct):
        _, vjp = jax.vjp(lambda a, b, c: j_ring_attention(
            a, b, c, JGROUP, impl=impl, **kw), q, k, v)
        return vjp(ct)

    jmesh = make_mesh((n,), ("x",), axis_types="auto")
    want = jax.jit(shard_map(g, mesh=jmesh, in_specs=(spec,) * 4,
                             out_specs=(spec,) * 3, check_vma=False))(
        *map(jnp.asarray, (q, k, v, ct)))
    _, got, mesh, _, _ = _port_grads(*map(torch.tensor, (q, k, v, ct)), n,
                                     SEQ, impl=impl, **kw)
    for a, b in zip(got, want):
        _close(unstack_shards(a, mesh, SEQ), np.asarray(b), False)


# -- the kernel wrapper's CPU path and the C entry ----------------------------------

def test_kernel_wrappers_on_cpu_are_the_plain_versions():
    n = 4
    q, k, v = (torch.tensor(a) for a in _case(n, seed=2))
    do = torch.randn(*q.shape[:-1], v.shape[-1])
    mesh = RankMesh(("x",), (n,))
    p = plan.OverlapPlanner().plan_ring_attention(2, 4, 4, 4, 2, 8, 8,
                                                  torch.float32, n)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        args = [stack_shards(a.numpy(), mesh, SEQ) for a in (q, k, v, do)]
        before = (fused.fused_ring_attention_kernel.launches,
                  fused.fused_ring_attention_bwd_kernel.launches)
        out, lse = fused.fused_ring_attention_kernel(*args[:3], GROUP, plan=p,
                                                     return_lse=True)
        got = fused.fused_ring_attention_bwd_kernel(*args[:3], out, args[3],
                                                    lse, GROUP, plan=p)
        want = fused.fused_ring_attention_bwd_plain(*args, GROUP, plan=p)
        with pytest.raises(ValueError, match="card"):
            fused.RingAttentionFn.apply(*args[:3], GROUP, p, None, 0, None)
    assert (fused.fused_ring_attention_kernel.launches,
            fused.fused_ring_attention_bwd_kernel.launches) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the lse: the folded state's, the flash oracle's over the whole K/V
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    with use_default(DiompContext(device="cpu")):
        _, flse = flash_attention_plain(q, k, v, return_lse=True)
    assert (lse.shape == (n, 2, 4, 4))
    assert torch.allclose(torch.tensor(unstack_shards(lse[..., None], mesh,
                                                      SEQ))[..., 0],
                          flse, atol=1e-5)
    # the gradient's rule: row 10's without its wide instance
    route = fused.ring_bwd_route
    assert route(torch.bfloat16, 64, 64, 1, 0, 256) == "wgmma"
    assert route(torch.float16, 112, 48, 2) == "wgmma"
    assert route(torch.float32, 64, 64, 1) == "simt"
    assert route(torch.bfloat16, 192, 128, 1) == "simt"      # MLA
    assert route(torch.bfloat16, 256, 256, 8) == "simt"      # paligemma
    assert route(torch.bfloat16, 64, 64, 12) == "simt"       # G off 64
    assert route(torch.bfloat16, 64, 64, 1, 8) == "simt"     # a pointer
    assert set(fused.fused_ring_attention_bwd_kernel.route_launches) == set(
        _build.ROUTE_CODES)


def test_lse_of_rows_that_see_no_key_is_inf():
    """Shared queries before every valid key (valid_len 0 on one row): the
    row's output is 0 and its lse +inf, so a P recomputed from it is 0."""
    q, k, v, p0, tq = _chunk_case(2)
    mesh = RankMesh(("x",), (2,))
    p = plan.OverlapPlanner().plan_ring_attention(
        2, tq, k.shape[1] // 2, 4, 2, 8, 8, torch.float32, 2,
        q_sharded=False, q_offset=None)
    vl = torch.tensor([[0, p0 + tq]] * 2, dtype=torch.int32)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        out, lse = fused.fused_ring_attention_kernel(
            stack_shards(q, mesh, REPL), *(stack_shards(a, mesh, SEQ)
                                           for a in (k, v)),
            GROUP, plan=p, q_offset=p0, valid_len=vl, return_lse=True)
    assert not out[:, 0].any() and bool(torch.isposinf(lse[:, 0]).all())
    assert bool(torch.isfinite(lse[:, 1]).all())


def test_bwd_abi_matches_the_cuda_source():
    """The ctypes argument list of both ring entries against their C
    signatures (one argument a comma); the gradient's route argument sits
    between the dtype and the stream, and it includes the shared headers."""
    for lib, fn in (("ring_attention", "repro_ring_attention"),
                    ("ring_attention_bwd", "repro_ring_attention_bwd")):
        src, fns = _build.LIBRARIES[lib]
        text = (CSRC / src).read_text()
        sig = re.search(fn + r"\(([^)]*)\)", text).group(1)
        assert len(fns[fn]) == sig.count(",") + 1, lib
        assert sig.replace(" ", "").replace("\n", "").endswith(
            "intdtype,introute,void*stream")
    text = (CSRC / "ring_attention_bwd.cu").read_text()
    assert '#include "attention_bwd.cuh"' in text
    assert '#include "ring_attention.cuh"' in text
    assert '#include "attention_bwd.cuh"' in (
        CSRC / "flash_attention_bwd.cu").read_text()


# -- attention_block under "ring" ------------------------------------------------------

BLOCK = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=8,
             kv_heads=2, d_ff=128, vocab_size=32, dtype="float32")


@pytest.fixture(scope="module")
def block():
    cfg, jcfg = ModelConfig(**BLOCK), JModelConfig(**BLOCK)
    mesh = RankMesh(("model", "data"), (4, 1))
    jparams = {k: v.astype(jnp.float32) for k, v in
               j_sch.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    lp_j = {kk.split("/")[1]: vv[0] for kk, vv in jparams.items()
            if kk.startswith("layers/")
            and kk.split("/")[1] in ("wq", "wk", "wv", "wo")}
    params = params_from_reference(cfg, mesh, {k: np.asarray(v) for k, v in
                                               jparams.items()},
                                   dtype=torch.float32)
    lp = {kk.split("/")[1]: vv.select(2, 0) for kk, vv in params.items()
          if kk.startswith("layers/") and kk.split("/")[1] in lp_j}
    rng = np.random.RandomState(8)
    x = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    ct = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    return cfg, jcfg, mesh, lp, lp_j, x, ct


def _block_grads(cfg, mesh, lp, x, ct, sp):
    """Loss <rank 0's output replica, ct>; the gradients of x and of each
    weight summed over the ranks, and the books of the backward."""
    ctx = dataclasses.replace(ParallelCtx.from_mesh(mesh), seq_parallel=sp)
    xs = stack_shards(x, mesh, (None, None, None)).requires_grad_()
    w = {n: t.detach().clone().requires_grad_() for n, t in lp.items()}
    dc = DiompContext(mesh=mesh, device="cpu")
    with use_default(dc):
        out, _ = layers.attention_block(xs, w, cfg, ctx)
        loss = (out[0, 0] * torch.tensor(ct)).sum()
        books = _books(dc)
        grads = torch.autograd.grad(loss, [xs, *w.values()])
        assert _books(dc) == books
    return {n: g.sum(dim=(0, 1)) for n, g in zip(("x", *w), grads)}


def test_attention_block_ring_grads_match_allgather_and_reference(block):
    cfg, jcfg, mesh, lp, lp_j, x, ct = block
    ring = _block_grads(cfg, mesh, lp, x, ct, "ring")
    gather = _block_grads(cfg, mesh, lp, x, ct, "allgather")
    for n in ring:
        torch.testing.assert_close(ring[n], gather[n], atol=3e-5, rtol=3e-5)

    # the reference's jax.grad of the same block inside shard_map, under
    # "allgather": its "ring" branch's custom VJP fails jax 0.9's varying-
    # axes check (as its own gradient test does); the loss is rank 0's
    # replica, as above
    jmesh = make_mesh((4, 1), ("model", "data"), axis_types="auto")
    jctx = dataclasses.replace(JCtx.from_mesh(jmesh), seq_parallel="allgather")

    def body(x, lp, ct):
        def loss(x, lp):
            out, _ = j_layers.attention_block(x, lp, jcfg, jctx)
            return jnp.sum(out * ct) * (lax.axis_index("model") == 0)

        gx, glp = jax.grad(loss, argnums=(0, 1))(x, lp)
        return gx[None], jax.tree.map(lambda t: t[None], glp)

    out_spec = P(("model", "data"))
    gx, glp = jax.jit(shard_map(
        body, mesh=jmesh, in_specs=(P(), P(), P()),
        out_specs=(out_spec, out_spec)))(jnp.asarray(x), lp_j,
                                         jnp.asarray(ct))
    # x and the weights enter replicated (invariant): the varying-axes
    # transpose sums their cotangents over "model", so every device holds
    # the whole gradient
    want = {"x": np.asarray(gx)[0],
            **{n: np.asarray(t)[0] for n, t in glp.items()}}
    for sp, got in (("ring", ring), ("allgather", gather)):
        for n in got:
            np.testing.assert_allclose(got[n].numpy(), want[n], atol=3e-5,
                                       rtol=3e-5, err_msg=f"{sp} {n}")


# -- on the card -----------------------------------------------------------------------

@pytest.mark.cuda
def test_gradient_kernel_against_plain_on_the_card():
    """Row 14 against its plain version: chip_smoke's
    ``check_ring_attention_bwd`` (ragged shapes, n 1-4, both layouts, f32
    and bf16, two launches bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.check_ring_attention_bwd(torch, chip_smoke.load_port(), gen)
