"""The port's stencil kernels and fused Minimod step held against JAX.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f32 fields agree to 2e-5 absolute on O(1) random fields (the
reference's own sweep tolerance: a 25-term sum rounded in f32 in another
order) and to 3e-6 on the 0.1-scaled fields of the fused step (the
reference's fused-step tolerance); bf16 to 2e-2 of the field's scale.
Call logs, byte logs and RMATracker windows must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.apps.minimod import pad_shards as j_pad_shards
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.kernels.stencil.fused import exchange_halos as j_exchange_halos
from repro.kernels.stencil.fused import fused_wave_step as j_fused_wave_step
from repro.kernels.stencil.ops import wave_step as j_wave_step

from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.core.rma import RMAError
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels.plan import OverlapPlanner
from repro_torch.kernels.stencil import fused as t_fused
from repro_torch.kernels.stencil.kernel import (leap, leap_plain,
                                                wave_step_kernel)
from repro_torch.kernels.stencil.ops import wave_step
from repro_torch.kernels.stencil.ref import RADIUS
from repro_torch.launch.mesh import RankMesh

RNG = np.random.RandomState(0)
R = RADIUS
SPEC = ("z", "y", None)


# ---------------------------------------------------------------------------
# the wave step: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Z,Y,X,bz", [
    (24, 20, 28, 8),
    (16, 16, 16, 16),
    (17, 12, 20, 8),        # ragged Z
])
def test_wave_step_matches_pallas(Z, Y, X, bz):
    u = RNG.randn(Z, Y, X).astype(np.float32)
    up = RNG.randn(Z, Y, X).astype(np.float32)
    want = np.asarray(j_wave_step(u, up, 0.1, impl="pallas", bz=bz,
                                  interpret=True))
    got = wave_step(torch.from_numpy(u), torch.from_numpy(up), 0.1,
                    impl="cuda")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        wave_step(torch.from_numpy(u), torch.from_numpy(up), 0.1).numpy(),
        want, atol=2e-5)


def test_wave_step_velocity_model_matches_pallas():
    u = RNG.randn(16, 16, 16).astype(np.float32)
    up = RNG.randn(16, 16, 16).astype(np.float32)
    c2 = RNG.uniform(0.05, 0.2, (16, 16, 16)).astype(np.float32)
    want = np.asarray(j_wave_step(u, up, c2, impl="pallas", bz=8,
                                  interpret=True))
    got = wave_step_kernel(torch.from_numpy(u), torch.from_numpy(up),
                           torch.from_numpy(c2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_leap_writes_into_out_views_and_checks_shapes():
    uext = torch.randn(2, 9 + 2 * R, 6 + 2 * R, 5 + 2 * R)
    prev = torch.randn(2, 9, 6, 5)
    out = torch.zeros(2, 11, 6, 5)
    before = leap.launches
    leap(uext, prev, 0.2, dx=1.5, out=out[:, 1:10])
    torch.testing.assert_close(out[:, 1:10], leap_plain(uext, prev, 0.2,
                                                        dx=1.5))
    assert leap.launches == before          # CPU tensors: plain version
    with pytest.raises(ValueError):
        leap(uext[..., 1:], prev, 0.2)


# ---------------------------------------------------------------------------
# the fused step: emulation vs JAX (1-D, 2-D, asymmetric, carried halos)
# ---------------------------------------------------------------------------


def _fields(Z, Y, X, nz, ny, ext, dtype=np.float32):
    ext = ext or (Z // nz,) * nz
    u = (RNG.randn(Z, Y, X) * 0.1).astype(dtype)
    up = (RNG.randn(Z, Y, X) * 0.1).astype(dtype)
    return j_pad_shards(u, ext), j_pad_shards(up, ext), ext


def _logs(ctx):
    return (ctx.stats(), ctx.byte_stats(), ctx.rma.puts, ctx.rma.put_bytes,
            ctx.rma.fences, dict(ctx.rma.window_bytes))


def _jax_steps(u, up, nz, ny, ext, steps, carried, j_dt=jnp.float32):
    mesh = make_mesh((nz, ny), ("z", "y"), axis_types="auto")
    zg, yg = JGroup(("z",), "z"), (JGroup(("y",), "y") if ny > 1 else None)

    def run(a, b):
        if carried:
            h = j_exchange_halos(a, zg, yg, z_extents=ext)
        for _ in range(steps):
            if carried:
                na, h = j_fused_wave_step(a, b, 0.1, zg, yg, z_extents=ext,
                                          halos=h, return_halos=True)
            else:
                na = j_fused_wave_step(a, b, 0.1, zg, yg, z_extents=ext)
            a, b = na, a
        return a

    ctx = JContext(mesh=mesh, segment_bytes=1 << 20)
    with j_use_default(ctx):
        f = jax.jit(shard_map(run, mesh=mesh, in_specs=(P("z", "y"),) * 2,
                              out_specs=P("z", "y")))
        out = np.asarray(f(jnp.asarray(u, j_dt), jnp.asarray(up, j_dt)),
                         np.float64)
    return out, _logs(ctx)


def _torch_steps(u, up, nz, ny, ext, steps, carried, t_dt=torch.float32):
    mesh = RankMesh(("z", "y"), (nz, ny))
    zg, yg = DiompGroup(("z",), "z"), (DiompGroup(("y",), "y")
                                       if ny > 1 else None)
    ctx = DiompContext(mesh=mesh, device="cpu")
    a = stack_shards(u, mesh, SPEC, dtype=t_dt)
    b = stack_shards(up, mesh, SPEC, dtype=t_dt)
    with use_default(ctx):
        if carried:
            h = t_fused.exchange_halos(a, zg, yg, z_extents=ext)
        for _ in range(steps):
            if carried:
                na, h = t_fused.fused_wave_step(a, b, 0.1, zg, yg,
                                                z_extents=ext, halos=h,
                                                return_halos=True)
            else:
                na = t_fused.fused_wave_step(a, b, 0.1, zg, yg,
                                             z_extents=ext)
            a, b = na, a
    return unstack_shards(a, mesh, SPEC).astype(np.float64), _logs(ctx)


@pytest.mark.parametrize("Z,Y,X,nz,ny,ext", [
    (64, 12, 10, 4, 1, None),            # symmetric 1-D, overlapped
    (32, 12, 10, 4, 1, None),            # no interior: planner fallback
    (16, 8, 8, 1, 1, None),              # 1-rank group: no exchange at all
    (64, 32, 8, 2, 2, None),             # 2-D (Z×Y) decomposition
    (22, 10, 8, 4, 1, (6, 6, 5, 5)),     # non-divisible -> asymmetric
    (44, 10, 8, 4, 1, (14, 10, 10, 10)), # heterogeneous extents
])
@pytest.mark.parametrize("carried", [False, True])
def test_fused_step_matches_jax(Z, Y, X, nz, ny, ext, carried):
    u, up, _ = _fields(Z, Y, X, nz, ny, ext)
    want, jlogs = _jax_steps(u, up, nz, ny, ext, 1, carried)
    got, tlogs = _torch_steps(u, up, nz, ny, ext, 1, carried)
    np.testing.assert_allclose(got, want, atol=3e-6)
    assert tlogs == jlogs


def test_carried_halos_two_steps_match_jax():
    u, up, _ = _fields(44, 10, 8, 4, 1, (14, 10, 10, 10))
    want, jlogs = _jax_steps(u, up, 4, 1, (14, 10, 10, 10), 2, True)
    got, tlogs = _torch_steps(u, up, 4, 1, (14, 10, 10, 10), 2, True)
    np.testing.assert_allclose(got, want, atol=3e-6)
    assert tlogs == jlogs


def test_fused_step_bf16_matches_jax():
    u, up, _ = _fields(64, 12, 8, 4, 1, None)
    want, _ = _jax_steps(u, up, 4, 1, None, 1, False, jnp.bfloat16)
    got, _ = _torch_steps(u, up, 4, 1, None, 1, False, torch.bfloat16)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_fused_kernel_wrapper_plain_version_matches_emulation():
    """The fused kernel's plain version (single-grid oracle) equals the
    emulation's single step, and the kernel path's audit trail equals
    the emulation's."""
    nz, Z, Y, X = 4, 12, 10, 9
    mesh = RankMesh(("z", "y"), (nz, 1))
    u, up = torch.randn(nz, 1, Z, Y, X), torch.randn(nz, 1, Z, Y, X)
    plan = OverlapPlanner().plan_halo_slots(Z, Y, X, torch.float32, nz)
    ctx = DiompContext(mesh=mesh, device="cpu")
    with use_default(ctx):
        emu = t_fused.fused_wave_step(u, up, 0.1, DiompGroup(("z",), "z"))
    before = t_fused.fused_wave_step_kernel.launches
    got = t_fused.fused_wave_step_kernel(u, up, 0.1, plan=plan)
    assert t_fused.fused_wave_step_kernel.launches == before
    torch.testing.assert_close(got, emu, atol=2e-5, rtol=0)
    rec = DiompContext(mesh=mesh, device="cpu")
    with use_default(rec):
        t_fused._record_single_step(u, DiompGroup(("z",), "z"))
    assert _logs(rec) == _logs(ctx)


def test_fused_step_rejects_bad_inputs():
    mesh = RankMesh(("z", "y"), (4, 1))
    zg = DiompGroup(("z",), "z")
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        u = torch.zeros(4, 1, 8, 8, 8)
        with pytest.raises(RMAError):
            t_fused.fused_wave_step(u, u, 0.1, zg, z_extents=(2, 2, 2, 2))
        with pytest.raises(ValueError):
            t_fused.fused_wave_step(u, u, 0.1, zg, z_extents=(8, 8, 8))
        bad = OverlapPlanner().plan_halo_slots(8, 8, 8, torch.float32, 2)
        with pytest.raises(ValueError):
            t_fused.fused_wave_step(u, u, 0.1, zg, plan=bad)
