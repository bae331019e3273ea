"""The port's ring collective matmul held against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f32 products agree to 1e-4 of the product's scale (both sum
in f32, in another order); f16/bf16 to 2e-2 of it, as the reference's own
sweeps state (the output is rounded to a 10- or 7-bit mantissa).  Call and
byte logs must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.kernels.ring_matmul.ops import matmul as j_matmul
from repro.kernels.ring_matmul.ops import \
    ring_allgather_matmul as j_ring_matmul

from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels.plan import RingPlan
from repro_torch.kernels.ring_matmul import fused as t_fused
from repro_torch.kernels.ring_matmul.kernel import matmul_kernel
from repro_torch.kernels.ring_matmul.ops import matmul, ring_allgather_matmul
from repro_torch.kernels.ring_matmul.ref import (matmul_ref,
                                                 ring_allgather_matmul_plain)
from repro_torch.launch.mesh import RankMesh

RNG = np.random.RandomState(0)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# local GEMM: the plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,bm,bk,bn,dt", [
    (64, 96, 48, 32, 32, 32, np.float32),
    (100, 130, 70, 32, 64, 32, np.float32),
    (256, 512, 256, 128, 128, 128, np.float32),
    (64, 64, 64, 32, 32, 32, np.float16),
    (33, 65, 17, 32, 32, 32, np.float32),       # ragged padding
    # ragged against the CUDA-core tile (128 x 128, K steps of 16)
    (130, 7, 260, 32, 32, 32, np.float32),      # K under one step
    (257, 100, 129, 128, 64, 128, np.float32),
    (1, 300, 5, 32, 128, 32, np.float32),
])
def test_plain_matmul_matches_pallas(M, K, N, bm, bk, bn, dt):
    x = RNG.randn(M, K).astype(dt)
    w = RNG.randn(K, N).astype(dt)
    want = np.asarray(j_matmul(x, w, impl="pallas", bm=bm, bk=bk, bn=bn,
                               interpret=True), np.float64)
    got = matmul(torch.from_numpy(x), torch.from_numpy(w), impl="cuda")
    tol = 2e-2 if dt == np.float16 else 1e-4
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_matmul_wrapper_takes_plain_version_on_cpu():
    x, w = torch.randn(5, 7), torch.randn(7, 3)
    before = matmul_kernel.launches
    torch.testing.assert_close(matmul_kernel(x, w), matmul_ref(x, w))
    assert matmul_kernel.launches == before


# ---------------------------------------------------------------------------
# the ring: fused and host emulations vs JAX, n = 1..8
# ---------------------------------------------------------------------------


def _both(n, T, K, N, dt, impl):
    """Run one ring in both packages; returns (got, want, jctx, tctx)."""
    np_dt, j_dt, t_dt, _ = DTYPES[dt]
    A = RNG.randn(T, K).astype(np_dt)
    B = RNG.randn(K, N).astype(np_dt)
    mesh = make_mesh((n,), ("x",), axis_types="auto")
    g_j, g_t = JGroup(("x",), "ring"), DiompGroup(("x",), "ring")
    jctx = JContext(mesh=mesh, segment_bytes=1 << 20)
    with j_use_default(jctx):
        f = jax.jit(shard_map(
            lambda a, b: j_ring_matmul(a, b, g_j, impl=impl),
            mesh=mesh, in_specs=(P("x", None), P(None, "x")),
            out_specs=P(None, "x")))
        want = np.asarray(f(jnp.asarray(A, j_dt), jnp.asarray(B, j_dt)),
                          np.float64)
    tmesh = RankMesh(("x",), (n,))
    tctx = DiompContext(mesh=tmesh, device="cpu")
    x = stack_shards(A, tmesh, ("x", None), dtype=t_dt)
    w = stack_shards(B, tmesh, (None, "x"), dtype=t_dt)
    with use_default(tctx):
        out = ring_allgather_matmul(x, w, g_t, impl=impl)
    assert out.dtype == t_dt
    got = unstack_shards(out, tmesh, (None, "x")).astype(np.float64)
    return got, want, jctx, tctx, (A, B)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["fused", "host"])
@pytest.mark.parametrize("n", range(1, 9))
def test_ring_emulations_match_jax(n, impl, dt):
    T, K, N = 3 * n, 17, 2 * n
    got, want, jctx, tctx, (A, B) = _both(n, T, K, N, dt, impl)
    scale = np.abs(A.astype(np.float64) @ B).max()
    tol = DTYPES[dt][3]
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got - A.astype(np.float64) @ B).max() <= tol * scale
    # put-byte parity: the same puts, the same per-rank bytes
    assert tctx.stats() == jctx.stats()
    assert tctx.byte_stats() == jctx.byte_stats()


def test_fused_issues_n_minus_1_puts():
    _, _, jctx, tctx, _ = _both(8, 16, 16, 16, "f32", "fused")
    desc = DiompGroup(("x",), "ring").descriptor()
    assert tctx.stats()[desc]["put"] == 7 == jctx.stats()[desc]["put"]


def test_overlap_false_is_the_allgather_reference():
    tmesh = RankMesh(("x",), (4,))
    g = DiompGroup(("x",))
    x, w = torch.randn(4, 3, 8), torch.randn(4, 8, 5)
    with use_default(DiompContext(mesh=tmesh, device="cpu")):
        a = ring_allgather_matmul(x, w, g, overlap=False)
        b = ring_allgather_matmul(x, w, g, impl="fused")
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(a, ring_allgather_matmul_plain(x, w))


@pytest.mark.parametrize("direction", ["cw", "ccw"])
def test_unidirectional_rings(direction):
    tmesh = RankMesh(("x",), (5,))
    x, w = torch.randn(5, 3, 9), torch.randn(5, 9, 4)
    with use_default(DiompContext(mesh=tmesh, device="cpu")):
        got = t_fused.fused_ring_allgather_matmul(
            x, w, DiompGroup(("x",)),
            plan=RingPlan(n=5, direction=direction, slots=2))
    torch.testing.assert_close(got, ring_allgather_matmul_plain(x, w))


def test_ring_on_a_two_axis_mesh():
    """A ring over one axis of a 2-D mesh: the other axis is a batch."""
    tmesh = RankMesh(("data", "model"), (2, 4))
    x, w = torch.randn(2, 4, 3, 6), torch.randn(2, 4, 6, 5)
    with use_default(DiompContext(mesh=tmesh, device="cpu")):
        got = ring_allgather_matmul(x, w, DiompGroup(("model",)))
    for d in range(2):
        torch.testing.assert_close(got[d], ring_allgather_matmul_plain(x[d],
                                                                       w[d]))


def test_plan_mismatch_rejected():
    tmesh = RankMesh(("x",), (4,))
    with use_default(DiompContext(mesh=tmesh, device="cpu")), \
            pytest.raises(ValueError):
        t_fused.fused_ring_allgather_matmul(
            torch.randn(4, 2, 8), torch.randn(4, 8, 2), DiompGroup(("x",)),
            plan=RingPlan(n=2))


def test_ring_kernel_wrapper_takes_plain_version_on_cpu():
    x, w = torch.randn(3, 4, 6), torch.randn(3, 6, 2)
    before = t_fused.fused_ring_allgather_matmul_kernel.launches
    got = t_fused.fused_ring_allgather_matmul_kernel(x, w,
                                                      plan=RingPlan(n=3))
    torch.testing.assert_close(got, ring_allgather_matmul_plain(x, w))
    assert t_fused.fused_ring_allgather_matmul_kernel.launches == before
