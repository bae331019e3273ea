"""Flash attention's gradient in the port, held against the reference.

The reference trains through its blockwise oracle under
``jax.value_and_grad``; the port's backward kernel
(``csrc/flash_attention_bwd.cu``) recomputes P from the forward's row
log-sum-exp, and its plain version (``flash_attention_bwd_plain``) runs the
same formulas in torch.  Here, over the reference's sweep
(``tests/test_kernels.py``, plus GQA, Dv != D, prefix-LM and a query offset
at the training path's head_dim 80 and at MLA's D = 192, Dv = 128): the
plain backward against ``jax.vjp``
of ``repro.kernels.flash_attention.ref.flash_attention_ref`` on the same
numpy inputs, and against torch autograd through the plain forward; the
plain forward's lse against the log-sum-exp of the scores; and the
autograd Function (:class:`FlashAttention`, the plain versions on the CPU)
end to end.  Tolerances, relative to each gradient's largest magnitude:
f32 2e-5 (f32 sums in another order, the reference's forward tolerance);
f16 inputs 2e-3 (the gradients rounded to f16: 2^-11, plus that order).
The card's kernel is held against the same plain version by
``chip_smoke.check_flash_bwd`` (``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref

from repro_torch.core.context import DiompContext, use_default
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import flash_attention

SWEEP = [
    # B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, dtype
    (2, 16, 16, 4, 2, 64, 64, True, 0, 0, np.float32),
    (1, 8, 24, 4, 1, 32, 32, True, 16, 0, np.float32),
    (2, 12, 12, 6, 6, 64, 64, False, 0, 0, np.float32),
    (1, 20, 20, 8, 2, 64, 64, True, 0, 5, np.float32),
    (1, 1, 33, 4, 2, 64, 64, True, 32, 0, np.float32),
    (1, 16, 16, 4, 2, 32, 16, True, 0, 0, np.float32),
    (2, 16, 16, 4, 4, 64, 64, True, 0, 0, np.float16),
    (1, 37, 37, 8, 1, 80, 80, True, 0, 0, np.float32),
    (2, 29, 29, 4, 2, 80, 48, True, 0, 17, np.float32),
    (1, 40, 40, 4, 4, 192, 128, True, 0, 0, np.float32),   # MLA's heads
]
TOL = {np.float32: 2e-5, np.float16: 2e-3}
IDS = [str(i) for i in range(len(SWEEP))]


@pytest.fixture(autouse=True)
def _cpu_context():
    with use_default(DiompContext(device="cpu")):
        yield


def _inputs(case, seed):
    B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, dt = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, H, D).astype(dt), rng.randn(B, Tk, KH, D).astype(dt),
            rng.randn(B, Tk, KH, Dv).astype(dt),
            rng.randn(B, Tq, H, Dv).astype(dt))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _plain_grads(q, k, v, do, causal, off, pfx):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = fa.flash_attention_plain(*t[:3], causal=causal, q_offset=off,
                                      prefix_len=pfx, return_lse=True)
    return fa.flash_attention_bwd_plain(*t[:3], o, t[3], lse, causal=causal,
                                        q_offset=off, prefix_len=pfx)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    q, k, v, do = _inputs(case, 0)
    causal, off, pfx, dt = case[7], case[8], case[9], case[10]

    def f(q, k, v):
        return j_ref(q, k, v, causal=causal, q_offset=off, prefix_len=pfx,
                     block=8)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _plain_grads(q, k, v, do, causal, off, pfx)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), np.asarray(w), TOL[dt], name)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_plain_backward_matches_torch_autograd(case):
    q, k, v, do = _inputs(case, 1)
    causal, off, pfx, dt = case[7], case[8], case[9], case[10]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal, q_offset=off,
                                   prefix_len=pfx)
    out.backward(torch.from_numpy(do))
    got = _plain_grads(q, k, v, do, causal, off, pfx)
    for name, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
        _close(g.numpy(), leaf.grad.numpy(), TOL[dt], name)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_lse_is_the_log_sum_exp_of_the_scores(case):
    q, k, v, _ = _inputs(case, 2)
    B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, dt = case
    _, lse = fa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_offset=off, prefix_len=pfx, return_lse=True)
    G = H // KH
    s = np.einsum("bqhd,bkhd->bqhk", q.astype(np.float64),
                  np.repeat(k, G, axis=2).astype(np.float64)) * D ** -0.5
    qp = off + np.arange(Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    vis = np.ones((Tq, Tk), bool)
    if causal:
        vis = (kp <= qp) | ((kp < pfx) & (qp < pfx))
    s = np.where(vis[None, :, None, :], s, -np.inf)
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_autograd_function_matches_plain(case):
    """flash_attention with grad enabled goes through the Function: the
    same output as the plain forward, the plain backward's gradients."""
    q, k, v, do = _inputs(case, 3)
    causal, off, pfx, dt = case[7], case[8], case[9], case[10]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, q_offset=off,
                          prefix_len=pfx)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    want = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, q_offset=off,
                                    prefix_len=pfx)
    assert torch.equal(out.detach(), want)
    out.backward(torch.from_numpy(do))
    got = _plain_grads(q, k, v, do, causal, off, pfx)
    for g, leaf in zip(got, leaves):
        assert torch.equal(leaf.grad, g)


def test_stacked_ranks_and_per_rank_offset():
    """Leading rank dims and a q_offset tensor of one offset a rank (what
    token-parallel attention passes): the gradient per rank equals the
    gradient of each rank's slice alone."""
    rng = np.random.RandomState(4)
    R, B, T, H, D = 2, 2, 12, 4, 16
    x = [torch.from_numpy(rng.randn(R, B, T, H, D).astype(np.float32))
         .requires_grad_() for _ in range(3)]
    off = torch.tensor([[0], [12]], dtype=torch.int32)
    out = flash_attention(x[0], x[1], x[2], causal=True, q_offset=off)
    do = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    out.backward(do)
    for r in range(R):
        y = [t.detach()[r].clone().requires_grad_() for t in x]
        o = fa.flash_attention_plain(*y, causal=True, q_offset=int(off[r, 0]))
        o.backward(do[r])
        for a, b in zip(x, y):
            _close(a.grad[r].numpy(), b.grad.numpy(), 2e-5, f"rank {r}")


@pytest.mark.parametrize("case", [SWEEP[7], SWEEP[8]], ids=["80", "80-48"])
def test_backward_wrapper_on_cpu_is_the_plain_version(case):
    """The gradient's wrapper on CPU tensors at the training path's head_dim
    80: the plain version's gradients (no launch counted on any route),
    against ``jax.vjp`` of the reference's oracle."""
    q, k, v, do = _inputs(case, 5)
    causal, off, pfx, dt = case[7], case[8], case[9], case[10]
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = fa.flash_attention_plain(*t[:3], causal=causal, q_offset=off,
                                      prefix_len=pfx, return_lse=True)
    bwd = fa.flash_attention_bwd_kernel
    before = (bwd.launches, dict(bwd.route_launches))
    got = bwd(*t[:3], o, t[3], lse, causal=causal, q_offset=off,
              prefix_len=pfx)
    assert (bwd.launches, bwd.route_launches) == before
    plain = fa.flash_attention_bwd_plain(*t[:3], o, t[3], lse, causal=causal,
                                         q_offset=off, prefix_len=pfx)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)

    def f(q, k, v):
        return j_ref(q, k, v, causal=causal, q_offset=off, prefix_len=pfx,
                     block=8)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        _close(g.numpy(), np.asarray(w), TOL[dt], name)


def test_gradient_refusals():
    q = torch.zeros(2, 8, 4, 16, requires_grad=True)
    with pytest.raises(ValueError, match="valid_len"):
        flash_attention(q, q, q, valid_len=4)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, q, q, q_offset=torch.tensor([0, 3]))
    # the ring's gradient runs: on CPU tensors the emulation's hand-written
    # backward, here over a ring of 2 stacked ranks
    from repro_torch.core.groups import DiompGroup
    from repro_torch.launch.mesh import RankMesh
    qr = torch.randn(2, 2, 4, 4, 16).requires_grad_()
    with use_default(DiompContext(mesh=RankMesh(("x",), (2,)),
                                  device="cpu")):
        flash_attention(qr, qr, qr, impl="ring",
                        group=DiompGroup(("x",), name="x")).sum().backward()
    assert qr.grad.shape == qr.shape and bool(torch.isfinite(qr.grad).all())
    assert qr.grad.abs().sum() > 0
    # without a gradient the serving paths keep per-row offsets
    with torch.no_grad():
        flash_attention(q, q, q, q_offset=torch.tensor([0, 3]),
                        valid_len=torch.tensor([8, 8]))
