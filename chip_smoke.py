#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a), holds every kernel against its plain PyTorch version on small
ragged shapes, then drives the port's main path at the paper's sizes:

* the ring (Cannon) all-gather matmul at N = 30240 in bf16 over 4 virtual
  ranks, fused and host-ring;
* Minimod at 1024³ over nz = 4, 10 steps from random fields, fused
  (carried halos) and host, each held against a single-grid oracle;
* one fused wave step at (256, 1024, 1024) per rank over nz = 4;

with every kernel's launch count zeroed just before that run and read just
after it.  Then it times each kernel at the main path's shapes beside its
plain version and, where one exists, the one PyTorch call that computes the
same function, times Minimod's two modes over repeated alternated runs, and
prints one JSON line of per-kernel numbers, the card's
name and power limit, and a last JSON line with the device.  Any failed
phase exits non-zero; so does a machine without CUDA and a directory that
does not hold the port.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): bytes/s of HBM3 and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
STENCIL_OPS_PER_POINT = 41      # 1 + 12·3 (star) + 4 (leapfrog) flops

# the main path's sizes
RING_N, RING_RANKS = 30240, 4
GRID, NZ, STEPS = 1024, 4, 10
MINIMOD_REPS = 5                # timed runs of each Minimod mode


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the type's peak rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Device time of ``fn`` in ms, from CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def load_port():
    """The port's kernel wrappers and their plain versions (``src`` must
    be on ``sys.path``)."""
    from types import SimpleNamespace
    from repro_torch.kernels.ring_matmul import fused as ring_fused
    from repro_torch.kernels.ring_matmul.kernel import matmul_kernel
    from repro_torch.kernels.ring_matmul.ref import (
        matmul_ref, ring_allgather_matmul_plain)
    from repro_torch.kernels.stencil import fused as st_fused
    from repro_torch.kernels.stencil.kernel import leap, leap_plain
    return SimpleNamespace(
        matmul_kernel=matmul_kernel, matmul_ref=matmul_ref,
        fused_ring_allgather_matmul_kernel=(
            ring_fused.fused_ring_allgather_matmul_kernel),
        ring_allgather_matmul_plain=ring_allgather_matmul_plain,
        leap=leap, leap_plain=leap_plain,
        fused_wave_step_kernel=st_fused.fused_wave_step_kernel,
        fused_step_plain=st_fused.fused_wave_step_plain)


# -- every kernel against its plain version on small, ragged shapes ----------
# Tolerances, relative to the result's largest magnitude: f32 1e-5 (GEMM) /
# 2e-5 (stencil), f32 sums in another order with fused multiply-adds; f16
# 2e-3 and bf16 1.6e-2, one ulp of the output type (2^-10 / 2^-7 relative)
# plus the accumulation order.  Each check also holds the wrapper to one
# launch count per call.  tests/test_torch_cuda.py runs the same checks.


def _counted(wrapper, fn):
    """``fn()``, checking that ``wrapper`` counted exactly one launch."""
    before = wrapper.launches
    got = fn()
    check(wrapper.launches == before + 1,
          f"{wrapper.__name__}: {wrapper.launches - before} launches counted")
    return got


def check_matmul(torch, k, g) -> None:
    """Ragged edges, every dtype."""
    for (M, K, N, dt, tol) in [(33, 65, 17, torch.float32, 1e-5),
                               (100, 130, 70, torch.float16, 2e-3),
                               (64, 96, 48, torch.bfloat16, 1.6e-2),
                               (256, 512, 256, torch.float32, 1e-5)]:
        x = torch.randn(M, K, generator=g, device="cuda").to(dt)
        w = torch.randn(K, N, generator=g, device="cuda").to(dt)
        want = k.matmul_ref(x, w)
        err = max_err(torch, _counted(k.matmul_kernel,
                                      lambda: k.matmul_kernel(x, w)), want)
        check(err <= tol * float(want.float().abs().max()),
              f"matmul {M}x{K}x{N} {dt}: err {err}")


def check_ring(torch, k, g) -> None:
    """n = 1..5 ranks, f32 and bf16, both directions and bidi."""
    from repro_torch.kernels.plan import RingPlan
    for n in range(1, 6):
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1.6e-2)):
            for direction in ("bidi", "cw", "ccw"):
                x = torch.randn(n, 5, 33, generator=g, device="cuda").to(dt)
                w = torch.randn(n, 33, 7, generator=g, device="cuda").to(dt)
                plan = RingPlan(n=n, direction=direction,
                                slots=1 if n == 1 else 2)
                want = k.ring_allgather_matmul_plain(x, w)
                kern = k.fused_ring_allgather_matmul_kernel
                got = _counted(kern, lambda: kern(x, w, plan=plan))
                err = max_err(torch, got, want)
                check(err <= tol * float(want.float().abs().max()),
                      f"ring n={n} {dt} {direction}: err {err}")


def check_leap(torch, k, g) -> None:
    """Ragged tile edges, scalar and per-point c2, sliced operands."""
    R = 4

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    for (Z, Y, X) in [(17, 12, 20), (9, 33, 70), (40, 8, 8)]:
        uext, prev = rnd(2, Z + 2 * R, Y + 2 * R, X + 2 * R), rnd(2, Z, Y, X)
        c2 = torch.rand(2, Z, Y, X, generator=g, device="cuda") * 0.2
        for c in (0.1, c2):
            want = k.leap_plain(uext, prev, c, dx=1.5)
            got = _counted(k.leap, lambda: k.leap(uext, prev, c, dx=1.5))
            err = max_err(torch, got, want)
            check(err <= 2e-5 * float(want.abs().max()),
                  f"leap {Z}x{Y}x{X}: err {err}")
        big = rnd(2, Z + 4 * R, Y + 2 * R, X + 2 * R)   # a slice view
        out = torch.zeros(2, Z + 2 * R, Y, X, device="cuda")
        _counted(k.leap, lambda: k.leap(big[:, R:Z + 3 * R], prev, 0.1,
                                        out=out[:, R:Z + R]))
        want = k.leap_plain(big[:, R:Z + 3 * R], prev, 0.1)
        check(max_err(torch, out[:, R:Z + R], want)
              <= 2e-5 * float(want.abs().max()), "leap on views")


def check_fused_step(torch, k, g) -> None:
    """Overlap, no interior (Z = 2R), one rank, odd ranks, per-point c2."""
    from repro_torch.kernels.plan import OverlapPlanner
    for (nz, Z, Y, X) in [(4, 12, 10, 9), (4, 8, 10, 9), (1, 12, 6, 40),
                          (3, 20, 33, 35)]:
        plan = OverlapPlanner().plan_halo_slots(Z, Y, X, torch.float32, nz)
        u = torch.randn(nz, 1, Z, Y, X, generator=g, device="cuda")
        up = torch.randn(nz, 1, Z, Y, X, generator=g, device="cuda")
        c2 = torch.rand(nz, 1, Z, Y, X, generator=g, device="cuda") * 0.2
        for c in (0.1, c2):
            want = k.fused_step_plain(u, up, c, dx=1.0)
            kern = k.fused_wave_step_kernel
            got = _counted(kern, lambda: kern(u, up, c, plan=plan))
            err = max_err(torch, got, want)
            check(err <= 2e-5 * float(want.abs().max()),
                  f"fused step nz={nz} Z={Z}: err {err}")


SMALL_CHECKS = {"matmul": check_matmul, "ring": check_ring,
                "leap": check_leap, "fused_step": check_fused_step}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 1: the card -----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: build every kernel (one nvcc per source, in parallel) -------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    k = load_port()
    wrappers = {"matmul": k.matmul_kernel,
                "fused_ring_allgather_matmul":
                    k.fused_ring_allgather_matmul_kernel,
                "wave_step": k.leap,
                "fused_wave_step": k.fused_wave_step_kernel}

    from repro_torch.apps.minimod import run_minimod
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.ring_matmul.ops import ring_allgather_matmul
    from repro_torch.kernels.stencil import fused as st_fused
    from repro_torch.kernels.stencil.ref import RADIUS, wave_step_ref
    from repro_torch.launch.mesh import RankMesh

    # -- phase 3: every kernel against its plain version, small shapes --------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1)
    for check_kernel in SMALL_CHECKS.values():
        check_kernel(torch, k, g)
    torch.cuda.synchronize()
    log(f"small-shape checks passed in {time.perf_counter() - t0:.1f} s")

    # -- phase 4-6: the main path, counts zeroed just before, read just after -
    g = torch.Generator(device=dev).manual_seed(0)
    n, N = RING_RANKS, RING_N
    t_loc = n_loc = N // n
    scale = N ** -0.25               # product entries of order one
    x = (torch.randn(n, t_loc, N, generator=g, device=dev) * scale
         ).to(torch.bfloat16)
    w = (torch.randn(n, N, n_loc, generator=g, device=dev) * scale
         ).to(torch.bfloat16)
    R = RADIUS
    zl = GRID // NZ

    for wrapper in wrappers.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ring_ctx = DiompContext(mesh=RankMesh(("ring",), (n,)), device=dev)
    ring = DiompGroup(("ring",), name="ring")
    with use_default(ring_ctx):
        y_fused = ring_allgather_matmul(x, w, ring, impl="fused")
        y_host = ring_allgather_matmul(x, w, ring, impl="host")
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    # Minimod's initial fields: random, so every rank boundary, both
    # Dirichlet edges and the ring's zeroed wrap carry data from step one
    u0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    up0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    # the fused step's stacked (nz, 1, Z, Y, X) fields: views of the same grid
    u1, up1 = (a.view(NZ, 1, zl, GRID, GRID) for a in (u0, up0))
    mm = {mode: run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS, mode=mode,
                            u0=u0, u_prev0=up0, device=dev)
          for mode in ("fused", "host")}
    step_ctx = DiompContext(mesh=RankMesh(("z", "y"), (NZ, 1)), device=dev)
    with use_default(step_ctx):
        y_step = st_fused.fused_wave_step(u1, up1, 0.1,
                                          DiompGroup(("z",), name="z"))
    torch.cuda.synchronize()
    launches = {name: wr.launches for name, wr in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path: launches {launches}; ring {ring_s:.2f} s (fused+host); "
        f"minimod fused {mm['fused'].wall_s:.3f} s, host "
        f"{mm['host'].wall_s:.3f} s; peak {peak_gb:.1f} GB")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # -- the main path's outputs, by the repo's own means ----------------------
    want = k.ring_allgather_matmul_plain(x, w)
    scale_y = float(want.float().abs().max())
    for mode, y in (("fused", y_fused), ("host", y_host)):
        err = max_err(torch, y, want)
        log(f"ring {mode}: max |err| {err:.4g} vs plain (max |y| {scale_y:.4g})")
        check(y.shape == (n, N, n_loc) and bool(torch.isfinite(y).all()),
              f"ring {mode}: bad output")
        # bf16 output: one bf16 ulp is 2^-8 of the value, plus the f32
        # accumulation-order difference
        check(err <= 1.6e-2 * scale_y, f"ring {mode}: err {err}")
    del want, y_fused, y_host
    # the single-grid oracle on the same inputs; tolerance 1e-5 of the
    # field's largest magnitude: f32 with fused multiply-adds, each of the
    # ten steps' rounding (about 1e-7 of the field) carried forward
    u, up = u0, up0
    for _ in range(STEPS):
        u, up = wave_step_ref(u, up, 0.1), u
    del up
    oracle_max = float(u.abs().max())
    for mode, r in mm.items():
        err = max_err(torch, r.field, u)
        log(f"minimod {mode}: max |err| {err:.4g} vs single-grid oracle "
            f"(max |u| {oracle_max:.4g}); puts {r.puts} / {r.put_bytes} B, "
            f"tracker {r.tracker_puts} / {r.tracker_put_bytes} B, "
            f"fences {r.fences}, plan overlap {r.plan.overlap}")
        check(r.field.shape == (GRID,) * 3
              and bool(torch.isfinite(r.field).all()), f"minimod {mode}")
        check(err <= 1e-5 * oracle_max, f"minimod {mode}: err {err}")
        # every rank boundary and both Dirichlet edges carry data
        for z in (0, zl - 1, zl, 2 * zl - 1, 2 * zl, 3 * zl - 1, 3 * zl,
                  GRID - 1):
            check(float(r.field[z].abs().max()) > 0.1 * oracle_max,
                  f"minimod {mode}: plane {z} carries no data")
    check(mm["fused"].plan.overlap, "fused Minimod fell back to no overlap")
    check(mm["fused"].put_bytes == mm["fused"].tracker_put_bytes > 0,
          "fused Minimod: OMPCCL put bytes != tracker bytes")
    check(mm["host"].tracker_puts == 2 and mm["host"].fences == 1,
          "host Minimod: not one two-slab exchange per step body")
    del u, mm
    want = k.fused_step_plain(u1, up1, 0.1, dx=1.0)
    err = max_err(torch, y_step, want)
    log(f"fused step: max |err| {err:.4g} vs plain")
    check(err <= 2e-5 * float(want.abs().max()), f"fused step: err {err}")
    del want, y_step
    torch.cuda.empty_cache()

    # -- timings at the main path's shapes --------------------------------------
    kernels = []

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, ops, dtype,
              library_ms):
        b_ms, b_by = bound(nbytes, ops, dtype)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        log(f"{name}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
            f"{library_ms}, bound {b_ms:.3f} ms by {b_by}), err {err:.4g}")

    # local GEMM of one rank: (t_loc x N) @ (N x n_loc)
    a, b = x[0].contiguous(), w[0].contiguous()
    got, want = k.matmul_kernel(a, b), k.matmul_ref(a, b)
    err = max_err(torch, got, want)
    check(err <= 1.6e-2 * float(want.float().abs().max()), "local GEMM")
    del got, want
    entry("matmul", "src/repro_torch/csrc/matmul.cu",
          "src/repro/kernels/ring_matmul/kernel.py:54", err,
          cuda_ms(torch, lambda: k.matmul_kernel(a, b), 3),
          cuda_ms(torch, lambda: k.matmul_ref(a, b), 3),
          2 * (t_loc * N + N * n_loc + t_loc * n_loc), 2 * t_loc * N * n_loc,
          "bfloat16", cuda_ms(torch, lambda: torch.matmul(a, b), 3))
    del a, b

    from repro_torch.kernels.plan import OverlapPlanner
    plan = OverlapPlanner().plan_ring_matmul(t_loc, N, n_loc, torch.bfloat16,
                                             n)
    got = k.fused_ring_allgather_matmul_kernel(x, w, plan=plan)
    want = k.ring_allgather_matmul_plain(x, w)
    err = max_err(torch, got, want)
    del got, want
    xf = x.reshape(n * t_loc, N)
    entry("fused_ring_allgather_matmul", "src/repro_torch/csrc/ring_matmul.cu",
          "src/repro/kernels/ring_matmul/fused.py:155", err,
          cuda_ms(torch, lambda: k.fused_ring_allgather_matmul_kernel(
              x, w, plan=plan), 1, warmup=0),
          cuda_ms(torch, lambda: k.ring_allgather_matmul_plain(x, w), 2),
          2 * 3 * N * N, 2 * N * N * N, "bfloat16",
          cuda_ms(torch, lambda: torch.matmul(xf, w), 2))
    del x, w, xf
    torch.cuda.empty_cache()

    # leap at 1024^3: one halo-extended grid, scalar c2
    uext = torch.randn(GRID + 2 * R, GRID + 2 * R, GRID + 2 * R,
                       generator=g, device=dev)
    prev = torch.randn((GRID,) * 3, generator=g, device=dev)
    got = k.leap(uext, prev, 0.1)
    want = k.leap_plain(uext, prev, 0.1)
    err = max_err(torch, got, want)
    check(err <= 2e-5 * float(want.abs().max()), "leap at 1024^3")
    del got, want
    torch.cuda.empty_cache()
    pts = GRID ** 3
    entry("wave_step", "src/repro_torch/csrc/wave_step.cu",
          "src/repro/kernels/stencil/kernel.py:80", err,
          cuda_ms(torch, lambda: k.leap(uext, prev, 0.1), 5),
          cuda_ms(torch, lambda: k.leap_plain(uext, prev, 0.1), 2),
          4 * (uext.numel() + 2 * pts), STENCIL_OPS_PER_POINT * pts,
          "float32", None)
    del uext, prev
    torch.cuda.empty_cache()

    splan = OverlapPlanner().plan_halo_slots(zl, GRID, GRID, torch.float32, NZ)
    got = k.fused_wave_step_kernel(u1, up1, 0.1, plan=splan)
    want = k.fused_step_plain(u1, up1, 0.1, dx=1.0)
    err = max_err(torch, got, want)
    del got, want
    torch.cuda.empty_cache()
    entry("fused_wave_step", "src/repro_torch/csrc/fused_wave_step.cu",
          "src/repro/kernels/stencil/fused.py:461", err,
          cuda_ms(torch, lambda: k.fused_wave_step_kernel(
              u1, up1, 0.1, plan=splan), 3),
          cuda_ms(torch, lambda: k.fused_step_plain(
              u1, up1, 0.1, dx=1.0), 2),
          4 * 3 * pts, STENCIL_OPS_PER_POINT * pts, "float32", None)

    # Minimod's time per step: the modes alternated over repeated runs on
    # the same inputs, each run's time loop timed with CUDA events
    per_step = {"fused": [], "host": []}
    for _ in range(MINIMOD_REPS):
        for mode, times in per_step.items():
            r = run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS, mode=mode,
                            u0=u0, u_prev0=up0, device=dev)
            times.append(r.wall_s / STEPS * 1e3)
            del r
    for mode, times in per_step.items():
        log(f"minimod {mode}: ms per step over {len(times)} runs: median "
            f"{statistics.median(times):.3f}, min {min(times):.3f}, max "
            f"{max(times):.3f} ({', '.join(f'{t:.3f}' for t in times)})")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
