"""The port's Minimod driver held against the JAX package's.

Every counter of ``MinimodResult`` (OMPCCL puts and bytes, RMATracker puts,
bytes, fences and windows, PGAS region sizes and allocation counts, the
extents, the plan's schedule) must be exactly equal; fields agree to 3e-6
absolute (the reference's own fused-vs-oracle tolerance for a unit point
source in f32).
"""

import numpy as np
import pytest
import torch

from repro.apps.minimod import pad_shards as j_pad_shards
from repro.apps.minimod import run_minimod as j_run_minimod
from repro.apps.minimod import unpad_shards as j_unpad_shards

from repro_torch.apps.minimod import (MODES, pad_shards, run_minimod,
                                      unpad_shards)
from repro_torch.kernels.stencil.ref import wave_step_ref

COUNTERS = ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
            "fences", "window_bytes", "region_sizes", "alloc_counts",
            "z_extents", "grid", "steps", "nz", "ny", "mode")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ["minimod_smoke", "minimod_hetero",
                                   "minimod_2d"])
def test_minimod_matches_jax(shape, mode):
    if shape == "minimod_2d" and mode == "none":
        with pytest.raises(ValueError):
            j_run_minimod(shape=shape, steps=3, mode=mode)
        with pytest.raises(ValueError):
            run_minimod(shape=shape, steps=3, mode=mode, device="cpu")
        return
    want = j_run_minimod(shape=shape, steps=3, mode=mode)
    got = run_minimod(shape=shape, steps=3, mode=mode, device="cpu")
    for attr in COUNTERS:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.plan.overlap == want.plan.overlap
    for carried in (True, False):
        assert got.plan.schedule(carried=carried) == \
            want.plan.schedule(carried=carried)
    assert got.field.shape == want.field.shape
    np.testing.assert_allclose(got.field.numpy(), want.field, atol=3e-6)
    assert got.energy == pytest.approx(want.energy, rel=1e-5)


def test_custom_initial_fields_match_jax():
    rng = np.random.RandomState(0)
    grid = (40, 12, 10)
    u0 = rng.randn(*grid) * 0.1
    up0 = rng.randn(*grid) * 0.1
    want = j_run_minimod(grid=grid, steps=2, nz=4, weights=(3, 3, 2, 2),
                         mode="fused", u0=u0, u_prev0=up0)
    got = run_minimod(grid=grid, steps=2, nz=4, weights=(3, 3, 2, 2),
                      mode="fused", u0=u0, u_prev0=up0, device="cpu")
    np.testing.assert_allclose(got.field.numpy(), want.field, atol=3e-6)
    for attr in COUNTERS:
        assert getattr(got, attr) == getattr(want, attr), attr


def test_modes_match_single_grid_oracle():
    grid, steps = (48, 16, 16), 4
    u = torch.zeros(grid)
    u[24, 8, 8] = 1.0
    up = torch.zeros(grid)
    for _ in range(steps):
        u, up = wave_step_ref(u, up, 0.1), u
    for weights in (None, (3, 2, 2, 1)):
        for mode in MODES:
            r = run_minimod(grid=grid, steps=steps, nz=4, weights=weights,
                            mode=mode, device="cpu")
            torch.testing.assert_close(r.field, u, atol=3e-6, rtol=0)


def test_put_traffic_parity_with_tracker():
    r = run_minimod(grid=(64, 12, 10), steps=5, nz=4, mode="fused",
                    device="cpu")
    assert r.plan.overlap
    assert r.puts == r.tracker_puts == 4
    assert r.put_bytes == r.tracker_put_bytes > 0
    assert r.fences == 2


@pytest.mark.parametrize("ext", [(6, 6, 5, 5), (14, 10, 10, 10), (4, 4)])
def test_pad_unpad_match_jax(ext):
    a = np.random.RandomState(1).randn(sum(ext), 3, 2).astype(np.float32)
    padded = pad_shards(torch.from_numpy(a), ext)
    np.testing.assert_array_equal(padded.numpy(), j_pad_shards(a, ext))
    np.testing.assert_array_equal(unpad_shards(padded, ext).numpy(),
                                  j_unpad_shards(j_pad_shards(a, ext), ext))


def test_run_minimod_rejects_bad_arguments():
    with pytest.raises(ValueError):
        run_minimod(grid=(16, 16, 16), nz=2, mode="warp", device="cpu")
    with pytest.raises(ValueError):
        run_minimod(grid=(16, 15, 16), nz=2, ny=2, device="cpu")
    with pytest.raises(ValueError):
        run_minimod(grid=(16, 16, 16), nz=2, steps=0, device="cpu")


@pytest.mark.parametrize("shape", ["minimod_smoke", "minimod_hetero"])
def test_shape_only_run_counts_as_cpu_run(shape):
    """A fused run on shape-only (meta) tensors, the emulation's records
    without its arithmetic, has a CPU run's counters: chip_smoke holds the
    card's full-size fused run against it."""
    meta = run_minimod(shape=shape, steps=3, mode="fused", device="meta")
    cpu = run_minimod(shape=shape, steps=3, mode="fused", device="cpu")
    for attr in COUNTERS:
        assert getattr(meta, attr) == getattr(cpu, attr), attr
    assert meta.field.device.type == "meta"
