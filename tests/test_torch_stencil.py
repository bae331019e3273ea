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


# ---------------------------------------------------------------------------
# the fused kernel's carried schedule: its plain version, its audit trail and
# the dispatcher's kernel route, against JAX and the emulation
# ---------------------------------------------------------------------------


def _carried_inputs(nz, per_point, Zl=12, Y=10, X=9):
    u = (RNG.randn(nz * Zl, Y, X) * 0.1).astype(np.float32)
    up = (RNG.randn(nz * Zl, Y, X) * 0.1).astype(np.float32)
    c2 = RNG.uniform(0.05, 0.2, (nz * Zl, Y, X)).astype(np.float32) \
        if per_point else 0.1
    return u, up, c2


def _jax_carried(u, up, c2, nz, steps):
    """The reference's carried time loop under shard_map: the field and the
    halos it returns, as global (nz·Z, Y, X) and (nz·R, Y, X) arrays."""
    mesh = make_mesh((nz, 1), ("z", "y"), axis_types="auto")
    zg = JGroup(("z",), "z")
    per_point = not np.isscalar(c2)

    def run(a, b, *c):
        h = j_exchange_halos(a, zg)
        for _ in range(steps):
            na, h = j_fused_wave_step(a, b, c[0] if per_point else c2, zg,
                                      halos=h, return_halos=True)
            a, b = na, a
        return a, h.z_lo, h.z_hi

    args = (u, up) + ((c2,) if per_point else ())
    with j_use_default(JContext(mesh=mesh, segment_bytes=1 << 20)):
        f = jax.jit(shard_map(run, mesh=mesh,
                              in_specs=(P("z", "y"),) * len(args),
                              out_specs=(P("z", "y"),) * 3))
        return [np.asarray(o, np.float64)
                for o in f(*(jnp.asarray(a) for a in args))]


@pytest.mark.parametrize("nz", [2, 3, 4])
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("steps", [1, 2])
def test_carried_plain_matches_jax(nz, per_point, steps):
    """fused_wave_step_carried_plain, chained from the prologue exchange,
    against the reference's carried step: the field and both returned
    halos."""
    u, up, c2 = _carried_inputs(nz, per_point)
    want = _jax_carried(u, up, c2, nz, steps)
    mesh = RankMesh(("z", "y"), (nz, 1))
    a, b = (stack_shards(x, mesh, SPEC) for x in (u, up))
    c = stack_shards(c2, mesh, SPEC) if per_point else c2
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        h = t_fused.exchange_halos(a, DiompGroup(("z",), "z"))
    for _ in range(steps):
        na, h = t_fused.fused_wave_step_carried_plain(a, b, c, h, dx=1.0)
        a, b = na, a
    got = [unstack_shards(x, mesh, SPEC) for x in (a, h.z_lo, h.z_hi)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-6)


def _forced_kernel_route(monkeypatch):
    """Route CPU steps as the card would: to the fused kernel's wrapper,
    whose CPU path is the plain versions."""
    route = t_fused.fused_step_route
    monkeypatch.setattr(t_fused, "fused_step_route",
                        lambda **kw: route(**{**kw, "on_card": True}))


def test_carried_recorder_matches_emulation_logs():
    """The kernel route's recorder writes exactly the emulation's
    carried-step audit trail (its puts, fence and reads)."""
    nz = 4
    mesh = RankMesh(("z", "y"), (nz, 1))
    zg = DiompGroup(("z",), "z")
    u, up = torch.randn(nz, 1, 12, 10, 8), torch.randn(nz, 1, 12, 10, 8)
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        h = t_fused.exchange_halos(u, zg)
    emu = DiompContext(mesh=mesh, device="cpu")
    with use_default(emu):
        t_fused.fused_wave_step(u, up, 0.1, zg, halos=h, return_halos=True)
    rec = DiompContext(mesh=mesh, device="cpu")
    with use_default(rec):
        t_fused._record_single_step(u, zg)
    assert _logs(rec) == _logs(emu)
    assert rec.rma.puts == 2 and rec.rma.fences == 1


@pytest.mark.parametrize("per_point", [False, True])
def test_kernel_route_matches_emulation(monkeypatch, per_point):
    """The dispatcher's kernel route (forced on the CPU), entering the
    carried loop with no halos and chaining two steps, equals the
    emulation in field, halos and every log; a single step too."""
    nz, Zl, Y, X = 4, 12, 10, 8
    mesh = RankMesh(("z", "y"), (nz, 1))
    zg = DiompGroup(("z",), "z")
    u, up = torch.randn(nz, 1, Zl, Y, X), torch.randn(nz, 1, Zl, Y, X)
    c2 = torch.rand(nz, 1, Zl, Y, X) * 0.2 if per_point else 0.1

    def run():
        ctx = DiompContext(mesh=mesh, device="cpu")
        a, b, h = u, up, None
        with use_default(ctx):
            for _ in range(2):
                na, h = t_fused.fused_wave_step(a, b, c2, zg, halos=h,
                                                return_halos=True)
                a, b = na, a
            single = t_fused.fused_wave_step(a, b, c2, zg)
        return a, h, single, _logs(ctx)

    want = run()
    _forced_kernel_route(monkeypatch)
    got = run()
    for g, w in ((got[0], want[0]), (got[1].z_lo, want[1].z_lo),
                 (got[1].z_hi, want[1].z_hi), (got[2], want[2])):
        torch.testing.assert_close(g, w, atol=3e-6, rtol=0)
    assert got[1].y_lo is None and got[1].y_hi is None
    assert got[3] == want[3]


def test_minimod_fused_kernel_route_matches_emulation(monkeypatch):
    """Minimod's fused loop through the kernel route (forced on the CPU)
    equals its emulation run in field and in every counter."""
    from repro_torch.apps.minimod import run_minimod
    kw = dict(grid=(48, 12, 8), steps=3, nz=4, mode="fused", device="cpu")
    want = run_minimod(**kw)
    _forced_kernel_route(monkeypatch)
    before = t_fused.fused_wave_step_kernel.launches
    got = run_minimod(**kw)
    assert t_fused.fused_wave_step_kernel.launches == before  # CPU: plain
    torch.testing.assert_close(got.field, want.field, atol=3e-6, rtol=0)
    for attr in ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
                 "fences", "window_bytes", "region_sizes", "alloc_counts"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_fused_kernel_wrapper_carried_plain_and_checks():
    """On CPU tensors the wrapper's carried step is its plain version;
    halos of the wrong shape are refused."""
    nz, Z, Y, X = 3, 12, 10, 9
    plan = OverlapPlanner().plan_halo_slots(Z, Y, X, torch.float32, nz)
    u, up = torch.randn(nz, 1, Z, Y, X), torch.randn(nz, 1, Z, Y, X)
    h = t_fused.Halos(torch.randn(nz, 1, R, Y, X), torch.randn(nz, 1, R, Y, X))
    out, new = t_fused.fused_wave_step_kernel(u, up, 0.1, plan=plan,
                                              halos=h, return_halos=True)
    want = t_fused.fused_wave_step_carried_plain(u, up, 0.1, h, dx=1.0)
    torch.testing.assert_close(out, want[0])
    torch.testing.assert_close(new.z_lo, want[1].z_lo)
    torch.testing.assert_close(new.z_hi, want[1].z_hi)
    assert float(new.z_lo[0].abs().max()) == 0.0
    assert float(new.z_hi[-1].abs().max()) == 0.0
    torch.testing.assert_close(new.z_lo[1:], out[:-1, :, Z - R:])
    torch.testing.assert_close(new.z_hi[:-1], out[1:, :, :R])
    assert t_fused.fused_wave_step_kernel(u, up, 0.1, plan=plan,
                                          halos=h).shape == u.shape
    single, none = t_fused.fused_wave_step_kernel(u, up, 0.1, plan=plan,
                                                  return_halos=True)
    assert none is None and single.shape == u.shape
    with pytest.raises(ValueError):
        t_fused.fused_wave_step_kernel(
            u, up, 0.1, plan=plan, halos=t_fused.Halos(h.z_lo[:, :, :2],
                                                       h.z_hi))


def test_fused_kernel_wrapper_refuses_a_plan_of_another_shard():
    """A plan made for another Z extent is refused on either schedule,
    and carried halos on a shard with no interior (Z = 2R, where the plan
    does not overlap) are refused: the carried kernel would leave rows of
    the new z_lo unwritten."""
    nz, Y, X = 3, 10, 8
    big = OverlapPlanner().plan_halo_slots(12, Y, X, torch.float32, nz)
    flat = OverlapPlanner().plan_halo_slots(2 * R, Y, X, torch.float32, nz)
    assert big.overlap and not flat.overlap
    u, up = torch.randn(nz, 1, 2 * R, Y, X), torch.randn(nz, 1, 2 * R, Y, X)
    h = t_fused.Halos(torch.randn(nz, 1, R, Y, X), torch.randn(nz, 1, R, Y, X))
    for plan, halos in ((big, h), (big, None), (flat, h)):
        with pytest.raises(ValueError):
            t_fused.fused_wave_step_kernel(u, up, 0.1, plan=plan,
                                           halos=halos)
    torch.testing.assert_close(
        t_fused.fused_wave_step_kernel(u, up, 0.1, plan=flat),
        t_fused.fused_wave_step_plain(u, up, 0.1, dx=1.0))
