"""The port's examples (``repro_torch.examples``) held against the
reference's examples and apps on the CPU.

* Cannon: the port's ``cannon`` on stacked ranks against the reference
  example's ``cannon`` under ``shard_map`` on the same numpy inputs, to
  1e-5 of the result's largest magnitude (f32 block GEMMs summed in
  another order), with equal put logs;
* Minimod: the example's ``MinimodResult`` counters exactly and its field
  to 3e-6 absolute (the reference's own fused-vs-oracle tolerance for a
  unit point source in f32) against the reference's ``run_minimod``;
* quickstart, cannon_matmul, minimod and serve_lm run to their last
  lines on the CPU;
* ``halo_loc``: the one-sided listing is shorter than the two-sided one in
  both packages (the paper's Fig. 8 claim).
"""

import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.apps.minimod import halo_loc as j_halo_loc
from repro.apps.minimod import run_minimod as j_run_minimod
from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup

import repro_torch as diomp
from repro_torch.apps.minimod import halo_loc
from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.examples import cannon_matmul, minimod, quickstart
from repro_torch.launch.mesh import RankMesh

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
            "fences", "window_bytes", "region_sizes", "alloc_counts",
            "z_extents", "grid", "steps", "nz", "ny", "mode")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("N,seed", [(256, 0), (128, 1), (64, 2)])
def test_cannon_matches_reference_example(N, seed):
    ref = _reference_example("cannon_matmul")
    rng = np.random.RandomState(seed)
    A = rng.randn(N, N).astype(np.float32)
    B = rng.randn(N, N).astype(np.float32)
    mesh = make_mesh((8,), ("ring",), axis_types="auto")
    g_j, g_t = JGroup(("ring",), name="ring"), DiompGroup(("ring",),
                                                          name="ring")
    jctx = JContext(mesh=mesh, segment_bytes=1 << 20)
    with j_use_default(jctx):
        want = np.asarray(jax.jit(shard_map(
            lambda a, b: ref.cannon(a, b, g_j), mesh=mesh,
            in_specs=(P("ring", None), P("ring", None)),
            out_specs=P("ring", None)))(A, B))
    ctx = DiompContext(mesh=RankMesh(("ring",), (8,)), device="cpu")
    with use_default(ctx):
        got = cannon_matmul.cannon(torch.from_numpy(A).view(8, N // 8, N),
                                   torch.from_numpy(B).view(8, N // 8, N),
                                   g_t)
    assert got.dtype == torch.float32 and got.shape == (8, N // 8, N)
    got = got.reshape(N, N).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, A @ B, rtol=0, atol=1e-5 * scale)
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()
    assert sum(v["put"] for v in ctx.stats().values()) == 7


def test_cannon_example_main_on_cpu(capsys):
    out = cannon_matmul.main(["256", "--device", "cpu"])
    assert out["err"] < 1e-4 and out["C"].shape == (8, 32, 256)
    assert capsys.readouterr().out.strip().endswith("cannon_matmul OK")
    with pytest.raises(SystemExit):
        cannon_matmul.main(["100", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["fused", "host", "none"])
@pytest.mark.parametrize("shape", ["minimod_hetero", "minimod_2d"])
def test_minimod_example_matches_reference(shape, mode, capsys):
    argv = ["--shape", shape, "--steps", "3", "--mode", mode,
            "--device", "cpu"]
    if shape == "minimod_2d" and mode == "none":
        with pytest.raises(ValueError):
            j_run_minimod(shape=shape, steps=3, mode=mode)
        with pytest.raises(ValueError):
            minimod.main(argv)
        return
    want = j_run_minimod(shape=shape, steps=3, mode=mode)
    got = minimod.main(argv)
    assert capsys.readouterr().out.strip().endswith("minimod OK")
    for attr in COUNTERS:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.plan.overlap == want.plan.overlap
    np.testing.assert_allclose(got.field.numpy(), want.field, atol=3e-6)


@pytest.mark.parametrize("argv,kw", [
    (["--grid", "48", "--nz", "4", "--weights", "3,2,2,1", "--steps", "4"],
     {"grid": (48,) * 3, "nz": 4, "weights": (3, 2, 2, 1), "steps": 4}),
    (["--grid", "32", "--nz", "2", "--ny", "2", "--steps", "4"],
     {"grid": (32,) * 3, "nz": 2, "ny": 2, "steps": 4}),
    (["--grid", "32", "--nz", "4", "--mode", "host", "--steps", "2"],
     {"grid": (32,) * 3, "nz": 4, "mode": "host", "steps": 2}),
])
def test_minimod_example_flags_match_reference(argv, kw):
    want = j_run_minimod(**kw)
    got = minimod.main(argv + ["--device", "cpu"])
    for attr in COUNTERS:
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_allclose(got.field.numpy(), want.field, atol=3e-6)


def test_quickstart_on_cpu(capsys):
    try:
        rt = quickstart.main(["--device", "cpu"])
        out = capsys.readouterr().out
        assert out.strip().endswith("quickstart OK")
        assert "unified runtime" in out and "analytic backend" in out
        assert rt.ctx is diomp.default_context()
        assert {r.name for r in rt.table()} == {"weights/w1", "kv_pages"}
        (calls,) = rt.ctx.stats().values()
        assert calls == {"put": 1, "allreduce": 2, "bcast": 1}
    finally:
        diomp.reset_default_context()


def test_serve_example_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_lm", "--device", "cpu", "--requests", "2", "--max-new", "2"])
    runpy.run_module("repro_torch.examples.serve_lm", run_name="__main__")
    out = capsys.readouterr().out
    assert '"requests_done": 2' in out and out.strip().endswith(" done")
    monkeypatch.setattr(sys, "argv", [
        "serve_lm", "--device", "cpu", "--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit):
        runpy.run_module("repro_torch.examples.serve_lm", run_name="__main__")


def test_halo_loc_one_sided_is_shorter():
    for counts in (halo_loc(), j_halo_loc()):
        assert 0 < counts["diomp"] < counts["two_sided"], counts


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for main in (quickstart.main, cannon_matmul.main, minimod.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    diomp.reset_default_context()
