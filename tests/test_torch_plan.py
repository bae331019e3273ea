"""The port's planner held against the JAX package's.

Schedules and ``split_extents`` must equal the reference record for record.
Budgets are the port's own (what its CUDA kernels stage in shared memory),
so slot counts, chunk heights and staging bytes may differ; the overlap
decision must agree wherever both budgets hold the stage, and at the
paper's 1024³ / nz = 4 Minimod cell the port must keep the overlapped
schedule that the TPU budget gives up.
"""

import itertools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import plan as jplan
from repro.core.streams import StreamPool as JStreamPool

from repro_torch.core.streams import StreamPool
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.ring_matmul.fused import _ring_slots

CSRC = Path(tplan.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("total,parts,weights,minimum", [
    (64, 4, None, 1), (22, 4, None, 1), (60, 4, (3, 2, 2, 1), 1),
    (60, 4, (30, 1, 1, 1), 4), (48, 4, None, 4), (1024, 4, None, 4),
    (101, 7, (1.5, 2, 3, 1, 1, 1, 9), 2), (9, 3, (1, 1, 100), 1),
    (8, 4, None, 4), (16, 4, (1, 1), 1), (10, 0, None, 1),
    (10, 2, (1, -1), 1)])
def test_split_extents_equal(total, parts, weights, minimum):
    try:
        want = jplan.split_extents(total, parts, weights, minimum=minimum)
    except ValueError:
        with pytest.raises(ValueError):
            tplan.split_extents(total, parts, weights, minimum=minimum)
        return
    assert tplan.split_extents(total, parts, weights, minimum=minimum) == want


def _steps(plan):
    return [tuple(getattr(st, f) for f in ("index", "compute_cw",
                                            "compute_ccw", "send_cw",
                                            "send_ccw", "slot"))
            for st in plan.schedule()]


@pytest.mark.parametrize("direction", ["bidi", "cw", "ccw"])
def test_ring_schedules_equal(direction):
    for n, slots in itertools.product(range(1, 10), (1, 2, 3, 5)):
        t = tplan.RingPlan(n=n, direction=direction, slots=slots)
        j = jplan.RingPlan(n=n, direction=direction, slots=slots)
        assert _steps(t) == _steps(j), (n, slots)
        assert t.exchange_steps == j.exchange_steps
        assert t.fold_steps() == j.fold_steps()
        for rank in range(n):
            assert t.sources(rank) == j.sources(rank)


def test_ring_plan_rejects_bad_direction():
    with pytest.raises(ValueError):
        tplan.RingPlan(n=4, direction="diagonal")


def test_halo_schedules_equal():
    for nz, ny, overlap, carried in itertools.product(
            (1, 2, 4), (1, 2), (True, False), (True, False)):
        kw = dict(nz=nz, ny=ny, halo=4, z_loc=16, y_loc=16, x=8,
                  slab_bytes=512, strip_bytes=256, overlap=overlap)
        t, j = tplan.HaloPlan(**kw), jplan.HaloPlan(**kw)
        assert t.schedule(carried=carried) == j.schedule(carried=carried)
        for attr in ("exchange_axes", "interior_z", "interior_y",
                     "puts_per_step", "halo_bytes_per_step"):
            assert getattr(t, attr) == getattr(j, attr), attr


@pytest.mark.parametrize("z,y,x,nz,ny", [
    (16, 16, 16, 4, 1), (8, 16, 16, 4, 1), (32, 16, 16, 1, 1),
    (32, 8, 16, 2, 2), (16, 12, 10, 4, 1), (16, 16, 64, 4, 2),
    (12, 48, 48, 4, 1), (128, 1024, 1024, 8, 1), (256, 1024, 1024, 4, 1)])
def test_halo_overlap_decision_matches_reference(z, y, x, nz, ny):
    t = tplan.OverlapPlanner().plan_halo_slots(z, y, x, torch.float32, nz,
                                               ny=ny)
    j = jplan.OverlapPlanner().plan_halo_slots(z, y, x, jnp.float32, nz,
                                               ny=ny)
    assert t.overlap == j.overlap
    for carried in (True, False):
        assert t.schedule(carried=carried) == j.schedule(carried=carried)
    assert (t.slab_bytes, t.strip_bytes) == (j.slab_bytes, j.strip_bytes)
    assert t.staging_bytes <= tplan.SMEM_BUDGET_DEFAULT


def test_paper_cell_keeps_overlap_on_hopper():
    """1024³ over nz = 4.  The reference's staging formula with Hopper's
    227 KB of shared memory plugged in as its budget stages
    (1+8)(8+8)(1032)·4 B ≈ 594 KB and falls back to the serialized
    schedule; the port's wave step stages a ring of eight (32+8)(64+8)
    f32 plane tiles on its TMA route, 90 KiB a block (two fit the
    budget), so the overlapped schedule stands."""
    j = jplan.OverlapPlanner(vmem_budget=tplan.SMEM_BUDGET_DEFAULT
                             ).plan_halo_slots(256, 1024, 1024, jnp.float32, 4)
    t = tplan.OverlapPlanner().plan_halo_slots(256, 1024, 1024,
                                               torch.float32, 4)
    assert not j.overlap
    assert t.overlap
    assert t.schedule(carried=True) == ("boundary", "put", "interior", "fence")
    assert t.staging_bytes <= tplan.SMEM_BUDGET_DEFAULT


def test_halo_plan_fallbacks():
    planner = tplan.OverlapPlanner()
    assert not planner.plan_halo_slots(8, 16, 16, torch.float32, 4).overlap
    lone = planner.plan_halo_slots(32, 16, 16, torch.float32, 1)
    assert not lone.overlap and lone.schedule() == ("all",)
    assert not planner.plan_halo_slots(32, 8, 16, torch.float32, 2,
                                       ny=2).overlap
    tiny = tplan.OverlapPlanner(smem_budget=1024)
    plan = tiny.plan_halo_slots(64, 64, 64, torch.float32, 4)
    assert tiny.plan_stencil_bz(64, 64, 64, torch.float32) == 1
    assert not plan.overlap
    assert plan.schedule() == ("put", "fence", "all")


def test_stencil_bz_degenerate():
    planner = tplan.OverlapPlanner()
    assert planner.plan_stencil_bz(3, 8, 8, torch.float32, bz=64) == 3
    assert planner.plan_stencil_bz(2, 2, 2, torch.float32) >= 1
    assert tplan.OverlapPlanner(smem_budget=256).plan_stencil_bz(
        64, 64, 64, torch.float32) == 1


def test_planner_consumes_plan_slots():
    calls = []

    class SpyPool(StreamPool):
        def plan_slots(self, working_set_bytes, budget=64 * 2**20):
            calls.append(working_set_bytes)
            return super().plan_slots(working_set_bytes, budget)

    planner = tplan.OverlapPlanner(pool=SpyPool(max_active=4))
    ring = planner.plan_ring_matmul(8, 32, 16, torch.float32, 8)
    halo = planner.plan_halo_slots(32, 16, 16, torch.float32, 4)
    assert calls and 2 <= ring.slots <= 4 and 2 <= halo.slots <= 4
    assert ring.stripe_bytes == 8 * 32 * 4


def test_ring_plan_at_paper_size():
    """N = 30240 bf16 over 4 ranks: the slots may pin no more than the
    all-gathered X (two per direction), floored at the reference's
    reuse-safe three: about 11 GB of stripe slots."""
    n, t_loc = 4, 30240 // 4
    plan = tplan.OverlapPlanner().plan_ring_matmul(
        t_loc, 30240, t_loc, torch.bfloat16, n)
    ref = jplan.RingPlan(n=n, direction="bidi", slots=plan.slots)
    assert _steps(plan) == _steps(ref)
    assert plan.slots == 2 and _ring_slots(plan) == 3
    slot_bytes = n * 2 * _ring_slots(plan) * plan.stripe_bytes
    assert 10e9 < slot_bytes < 12e9


def test_matmul_tiles_are_the_kernels():
    """Each route's tile: aligned bf16 takes the tensor-core tile, f32 and
    unaligned 16-bit the CUDA-core one; both clip to the problem and
    refuse a budget their stages do not fit."""
    planner = tplan.OverlapPlanner()
    assert planner.plan_matmul_tiles(4096, 4096, 4096, torch.bfloat16) == \
        tplan.TC_TILE
    assert planner.plan_matmul_tiles(4096, 4096, 4096, torch.float32) == \
        tplan.MM_TILE
    assert planner.plan_matmul_tiles(4096, 4100, 4096, torch.float16) == \
        tplan.MM_TILE
    assert planner.plan_matmul_tiles(33, 8, 17, torch.float32) == (33, 8, 17)
    assert planner.plan_matmul_tiles(100, 48, 16, torch.bfloat16) == \
        (100, 48, 16)
    with pytest.raises(ValueError):
        tplan.OverlapPlanner(smem_budget=1024).plan_matmul_tiles(
            64, 64, 64, torch.float32)
    mm = tplan.OverlapPlanner.mm_smem_bytes()
    assert tplan.OverlapPlanner(smem_budget=mm).plan_matmul_tiles(
        256, 256, 256, torch.float32) == tplan.MM_TILE
    with pytest.raises(ValueError):
        tplan.OverlapPlanner(smem_budget=mm - 1).plan_matmul_tiles(
            256, 256, 256, torch.float32)
    bm, bk, bn = tplan.TC_TILE
    stages = tplan.TC_STAGES * (bm * bk + bk * bn) * 2
    assert stages <= tplan.SMEM_BUDGET_DEFAULT
    assert tplan.OverlapPlanner(smem_budget=stages).plan_matmul_tiles(
        256, 256, 256, torch.bfloat16) == tplan.TC_TILE
    with pytest.raises(ValueError):
        tplan.OverlapPlanner(smem_budget=stages - 1).plan_matmul_tiles(
            256, 256, 256, torch.bfloat16)


def test_ring_plan_carries_the_route_tile():
    plan = tplan.OverlapPlanner().plan_ring_matmul(
        7560, 30240, 7560, torch.bfloat16, 4)
    assert plan.tile == tplan.TC_TILE
    plan = tplan.OverlapPlanner().plan_ring_matmul(
        5, 33, 7, torch.bfloat16, 4)
    assert plan.tile == (5, 16, 7)


@pytest.mark.parametrize("dtype,k,n,ptrs,route", [
    (torch.float32, 30240, 7560, (0, 256), "simt"),
    (torch.float32, 64, 64, (), "simt"),
    (torch.bfloat16, 30240, 7560, (0, 256, 1 << 20), "wgmma"),   # main path
    (torch.float16, 264, 136, (16, 32), "wgmma"),
    (torch.bfloat16, 8, 8, (), "wgmma"),
    (torch.bfloat16, 130, 136, (0, 0), "simt"),     # K off the rule
    (torch.float16, 264, 70, (0, 0), "simt"),       # N off the rule
    (torch.bfloat16, 264, 136, (0, 8), "simt"),     # a pointer off 16 B
    (torch.bfloat16, 33, 7, (), "simt"),
])
def test_gemm_route_rule(dtype, k, n, ptrs, route):
    assert tplan.gemm_route(dtype, k, n, *ptrs) == route


def test_both_wrappers_share_the_route_rule():
    from repro_torch.kernels import _build
    from repro_torch.kernels.ring_matmul import fused, kernel
    assert kernel.gemm_route is fused.gemm_route is tplan.gemm_route
    for wrapper in (kernel.matmul_kernel,
                    fused.fused_ring_allgather_matmul_kernel):
        assert set(wrapper.route_launches) == set(_build.ROUTE_CODES) \
            == {"simt", "wgmma"}
    before = dict(kernel.matmul_kernel.route_launches)
    kernel.matmul_kernel(torch.randn(8, 16, dtype=torch.bfloat16),
                         torch.randn(16, 8, dtype=torch.bfloat16))
    assert kernel.matmul_kernel.route_launches == before   # the CPU counts none


def _defines(name):
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}


def test_planner_tiles_match_the_cuda_sources():
    mm = _defines("matmul.cuh")
    assert (mm["MM_BM"], mm["MM_BK"], mm["MM_BN"]) == tplan.MM_TILE
    assert (mm["MM_STAGES"], mm["MM_APAD"]) == (tplan.MM_STAGES,
                                                tplan.MM_APAD)
    # the CUDA-core tile's dynamic shared memory, mm_smem_bytes, evaluated:
    # two blocks of it fit an SM
    expr = re.search(r"mm_smem_bytes\(\) \{\s*return ([^;]+);",
                     (CSRC / "matmul.cuh").read_text()).group(1)
    got = eval(" ".join(expr.split()), dict(mm))
    assert got == tplan.OverlapPlanner.mm_smem_bytes() == 3 * (
        16 * 132 + 16 * 128) * 4
    assert 2 * (got + 1024) <= 233_472
    assert (mm["TC_BM"], mm["TC_BK"], mm["TC_BN"]) == tplan.TC_TILE
    assert mm["TC_STAGES"] == tplan.TC_STAGES
    st = _defines("wave_step.cu")
    assert (st["TY"], st["TX"]) == tplan.STENCIL_TILE
    assert _defines("stencil_ring.cuh")["R"] == 4


def test_stencil_tiles_match_the_cuda_source():
    """The plane ring both wave-step kernels walk (stencil_ring.cuh): tile,
    ring, threads (2 x 4 outputs a thread), both kernels' route codes, and
    the launch's dynamic shared memory (``leap_tma_smem_bytes``) against
    the planner's stage, two of which fit the budget."""
    st = _defines("stencil_ring.cuh")
    assert (st["LEAP_TY"], st["LEAP_TX"]) == tplan.STENCIL_TMA_TILE
    assert st["LEAP_STAGES"] == tplan.STENCIL_STAGES >= st["R"] + 3
    assert st["LEAP_THREADS"] == st["LEAP_TY"] // 2 * st["LEAP_TX"] // 4
    for src, enum in (("wave_step.cu", r"enum LeapRoute \{ kLeapSimt = "
                       r"(\d), kLeapTma = (\d) \}"),
                      ("fused_wave_step.cu", r"enum FusedRoute \{ kFusedSimt"
                       r" = (\d), kFusedTma = (\d) \}")):
        codes = re.search(enum, (CSRC / src).read_text()).groups()
        assert tuple(int(c) for c in codes) == (
            tplan.STENCIL_ROUTES.index("simt"),
            tplan.STENCIL_ROUTES.index("tma"))
        assert '#include "stencil_ring.cuh"' in (CSRC / src).read_text()
    text = (CSRC / "stencil_ring.cuh").read_text()
    expr = re.search(r"leap_tma_smem_bytes\(\) \{\s*return ([^;]+);",
                     text).group(1)
    got = eval(" ".join(expr.split()), {k: st[k] for k in (
        "LEAP_STAGES", "LEAP_TY", "LEAP_TX", "R")})
    planner = tplan.OverlapPlanner()
    for y, x in ((1024, 1024), (8, 8), (33, 70)):
        assert got == planner.stencil_stage_bytes(y, x, torch.float32)
    assert got == 128 + 8 * 40 * 72 * 4 + 16 * 8
    assert 2 * got <= tplan.SMEM_BUDGET_DEFAULT
    assert planner.stencil_stage_bytes(1024, 1024, torch.float32,
                                       route="simt") == 16 * 40 * 4


def test_scan_constants_match_the_cuda_source():
    """linear_scan.cu's sub-chunk, threads, limits, route codes, prefill
    instances and the launch's dynamic shared memory (``scan_smem_bytes``)
    against the planner: one block an SM at chunks of 64, two at 32."""
    from repro_torch.kernels.linear_scan import kernel as ls
    sc = _defines("linear_scan.cu")
    assert sc["SCAN_SUB"] == tplan.SCAN_SUB == 16
    assert sc["SCAN_THREADS"] == tplan.SCAN_THREADS == 256
    assert sc["CMAX"] == ls.MAX_CHUNK and sc["DMAX"] == ls.MAX_DIM
    assert sc["DEC_ROWS"] == 16
    text = (CSRC / "linear_scan.cu").read_text()
    codes = re.search(r"enum ScanRoute \{ kScanPrefill = (\d), kScanDecode "
                      r"= (\d) \}", text).groups()
    assert tuple(int(c) for c in codes) == (
        tplan.SCAN_ROUTES.index("prefill"), tplan.SCAN_ROUTES.index("decode"))
    inst = sorted(int(c) for c in re.findall(r"launch_prefill<(\d+)>\(prm",
                                             text))
    assert inst == [16, 32, 64]
    for chunk in range(1, 65):
        ci = tplan.scan_instance(chunk)
        assert ci in inst and chunk <= ci and (ci == 16 or chunk > ci // 2)
    expr = re.search(r"scan_smem_bytes\(int CI, int M4, int N4\) \{\s*"
                     r"return ([^;]+);", text).group(1)
    expr = " ".join(expr.split()).replace("/", "//")
    for ci, m, n in itertools.product((16, 32, 64), (8, 16, 18, 64),
                                      (8, 37, 40, 64)):
        m4, n4 = -(-m // 4) * 4, -(-n // 4) * 4
        got = eval(expr, {"CI": ci, "M4": m4, "N4": n4})
        assert got == tplan.scan_smem_bytes(ci, m, n)
    assert tplan.scan_smem_bytes(64, 64, 64) <= tplan.SMEM_BUDGET_DEFAULT
    # two blocks an SM at chunks of 32: 228 KiB an SM, 1 KiB reserved each
    assert 2 * (tplan.scan_smem_bytes(32, 64, 64) + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype,x,aligned,route", [
    (torch.float32, 1024, (0, 4128, 4128 * 1032, 4096, 1 << 22), "tma"),
    (torch.float32, 20, (0, 112, 2240, 80), "tma"),
    (torch.float32, 8, (), "tma"),
    (torch.float32, 70, (0, 312), "simt"),                 # X off 4
    (torch.float32, 9, (), "simt"),
    (torch.float32, 1024, (0, 4128, 4), "simt"),           # a pointer off 16
    (torch.float32, 64, (0, 264), "simt"),                 # a stride off 16
    (torch.bfloat16, 1024, (0, 2064), "simt"),              # f32 only
    (torch.float16, 64, (), "simt"),
])
def test_stencil_route_rule(dtype, x, aligned, route):
    assert tplan.stencil_route(dtype, x, *aligned) == route


@pytest.mark.parametrize("t,route", [
    (1, "decode"), (2, "prefill"), (15, "prefill"), (17, "prefill"),
    (2000, "prefill")])
def test_scan_route_rule(t, route):
    assert tplan.scan_route(t) == route


def test_stencil_and_scan_wrappers_count_per_route():
    """Both wrappers use the planner's rule and count per route; CPU
    tensors take the plain versions and count nothing."""
    from repro_torch.kernels.linear_scan import kernel as ls
    from repro_torch.kernels.stencil import kernel as st
    assert st.stencil_route is tplan.stencil_route
    assert ls.scan_route is tplan.scan_route
    assert set(st.leap.route_launches) == set(tplan.STENCIL_ROUTES) \
        == {"simt", "tma"}
    assert set(ls.linear_scan_kernel.route_launches) \
        == set(tplan.SCAN_ROUTES) == {"prefill", "decode"}
    before = (dict(st.leap.route_launches),
              dict(ls.linear_scan_kernel.route_launches))
    st.leap(torch.randn(1, 9, 12, 16), torch.randn(1, 1, 4, 8), 0.1)
    x = torch.randn(2, 1, 8)
    ls.linear_scan_kernel(x, x, torch.rand(2, 1, 8), x)
    assert (st.leap.route_launches,
            ls.linear_scan_kernel.route_launches) == before


def test_stencil_bz_by_route():
    """The chunk is 32 planes on both routes; a budget that holds the CUDA
    cores' 2.5 KiB tile twice but not the TMA ring's 90 KiB bottoms out
    only on the TMA route."""
    planner = tplan.OverlapPlanner()
    for route in tplan.STENCIL_ROUTES:
        assert planner.plan_stencil_bz(1024, 1024, 1024, torch.float32,
                                       route=route) == 32
    assert planner.plan_stencil_bz(4, 1024, 1024, torch.float32) == 4
    small = tplan.OverlapPlanner(smem_budget=64 * 1024)
    assert small.plan_stencil_bz(1024, 1024, 1024, torch.float32,
                                 route="simt") == 32
    assert small.plan_stencil_bz(1024, 1024, 1024, torch.float32) == 1


@pytest.mark.parametrize("dtype,d,dv,g,aligned,route", [
    (torch.bfloat16, 128, 128, 16, (0, 256, 4096), "wgmma"),  # glm4 decode
    (torch.bfloat16, 256, 256, 8, (16, 512), "wgmma"),        # paligemma
    (torch.bfloat16, 64, 64, 1, (), "wgmma"),                 # zamba2
    (torch.float16, 128, 64, 64, (32,), "wgmma"),             # Dv != D
    (torch.float16, 256, 128, 4, (), "wgmma"),
    (torch.float32, 128, 128, 16, (0, 256), "simt"),          # no TF32
    (torch.float32, 64, 64, 1, (), "simt"),
    (torch.float32, 80, 80, 1, (0, 160), "simt"),
    (torch.bfloat16, 80, 80, 1, (0, 160, 2560), "wgmma"),     # stablelm-3b
    (torch.bfloat16, 32, 32, 4, (), "wgmma"),                 # D off 64
    (torch.float16, 80, 48, 2, (), "wgmma"),
    (torch.bfloat16, 16, 112, 64, (), "wgmma"),
    (torch.bfloat16, 48, 24, 2, (), "simt"),                  # Dv off 16
    (torch.bfloat16, 72, 64, 1, (), "simt"),                  # D off 16
    (torch.float16, 80, 80, 4, (), "wgmma"),
    (torch.bfloat16, 128, 96, 2, (), "wgmma"),                # Dv off 64
    (torch.bfloat16, 192, 128, 2, (), "wgmma"),               # MLA's D
    (torch.bfloat16, 144, 144, 1, (), "simt"),                # Dv past 128
    (torch.bfloat16, 80, 256, 8, (), "wgmma"),
    (torch.bfloat16, 320, 64, 1, (), "simt"),                 # D past 256
    (torch.bfloat16, 128, 512, 1, (), "simt"),                # Dv past 256
    (torch.bfloat16, 128, 128, 3, (), "simt"),                # G off 64
    (torch.bfloat16, 128, 128, 128, (), "simt"),
    (torch.bfloat16, 128, 128, 16, (0, 8), "simt"),           # a pointer
    (torch.float16, 64, 64, 2, (256, 24), "simt"),            # a stride
])
def test_attention_route_rule(dtype, d, dv, g, aligned, route):
    assert tplan.attention_route(dtype, d, dv, g, *aligned) == route


def test_attention_route_over_the_sweep():
    """dtype x D x Dv x G x alignment against the rule as stated: D a
    multiple of 16 in [16, 256], Dv one of the instances' widths."""
    def d_ok(x):
        return 16 <= x <= 256 and x % 16 == 0

    def dv_ok(x):
        return (16 <= x <= 128 and x % 16 == 0) or x == 256

    for dt, d, dv, g, off in itertools.product(
            (torch.float32, torch.float16, torch.bfloat16),
            (8, 16, 32, 48, 64, 72, 80, 128, 144, 192, 200, 240, 256, 272,
             512),
            (16, 24, 48, 64, 80, 112, 128, 160, 192, 256, 320),
            (1, 2, 3, 8, 12, 16, 64, 96), (0, 2, 16)):
        want = ("wgmma" if dt != torch.float32 and d_ok(d)
                and dv_ok(dv) and g in (1, 2, 8, 16, 64)
                and off % 16 == 0 else "simt")
        assert tplan.attention_route(dt, d, dv, g, 1 << 20, off) == want


@pytest.mark.parametrize("dtype,d,dv,g,route", [
    (torch.bfloat16, 192, 128, 1, "wgmma"),   # deepseek-v3's MLA chunk
    (torch.float16, 192, 128, 1, "wgmma"),
    (torch.bfloat16, 256, 128, 1, "wgmma"),
    (torch.bfloat16, 200, 128, 1, "simt"),    # D off 16
    (torch.bfloat16, 272, 128, 1, "simt"),    # D past 256
    (torch.float32, 192, 128, 1, "simt"),     # no TF32
    (torch.bfloat16, 192, 192, 1, "simt"),    # Dv has no instance
    (torch.bfloat16, 128, 128, 8, "wgmma"),   # qwen1.5-110b, 8 q a kv head
    (torch.bfloat16, 128, 128, 12, "simt"),   # command-r-plus: G = 12
])
def test_attention_route_at_the_new_served_shapes(dtype, d, dv, g, route):
    """The widened rule at the shapes of this slice's served models (the
    gradient's rule keeps Dv to 128 and D to 128 or MLA's 192)."""
    assert tplan.attention_route(dtype, d, dv, g, 0, 256) == route
    assert tplan.attention_bwd_route(dtype, d, dv, g) == (
        "wgmma" if route == "wgmma" and (d <= 128 or d == 192)
        and dv <= 128 else "simt")


def test_both_attention_wrappers_share_the_route_rule():
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ring_attention import fused as ra
    assert fa.attention_route is ra.attention_route is tplan.attention_route
    for wrapper in (fa.flash_attention_kernel, ra.fused_ring_attention_kernel):
        assert set(wrapper.route_launches) == set(_build.ROUTE_CODES) \
            == {"simt", "wgmma"}
    before = dict(fa.flash_attention_kernel.route_launches)
    combines = fa.flash_attention_kernel.combine_launches
    q = torch.randn(1, 1, 16, 128, dtype=torch.bfloat16)
    kv = torch.randn(1, 300, 1, 128, dtype=torch.bfloat16)
    with use_default(DiompContext(device="cpu")):
        fa.flash_attention_kernel(q, kv, kv)
    assert fa.flash_attention_kernel.route_launches == before  # CPU: none
    assert fa.flash_attention_kernel.combine_launches == combines


@pytest.mark.parametrize("dtype,d,dv,g,aligned,route", [
    (torch.bfloat16, 80, 80, 1, (0, 160, 2560), "wgmma"),     # stablelm-3b
    (torch.float16, 64, 128, 4, (16, 512), "wgmma"),          # Dv != D
    (torch.bfloat16, 16, 16, 64, (), "wgmma"),
    (torch.float16, 80, 48, 1, (), "wgmma"),
    (torch.bfloat16, 128, 128, 8, (), "wgmma"),
    (torch.bfloat16, 192, 128, 1, (0, 384, 49152), "wgmma"),  # deepseek MLA
    (torch.float16, 192, 64, 2, (), "wgmma"),                 # wide, Dv < 128
    (torch.float32, 192, 128, 1, (), "simt"),                 # no TF32
    (torch.bfloat16, 192, 256, 1, (), "simt"),                # Dv past 128
    (torch.bfloat16, 192, 128, 1, (0, 8), "simt"),            # a pointer
    (torch.bfloat16, 176, 128, 1, (), "simt"),                # no instance
    (torch.float32, 80, 80, 1, (0, 160), "simt"),             # no TF32
    (torch.float32, 64, 64, 4, (), "simt"),
    (torch.bfloat16, 72, 72, 1, (), "simt"),                  # D off 16
    (torch.float16, 64, 40, 1, (), "simt"),                   # Dv off 16
    (torch.bfloat16, 256, 256, 8, (0, 512, 4096), "wgmma"),   # paligemma
    (torch.float16, 256, 256, 1, (), "wgmma"),                # 256-wide
    (torch.float32, 256, 256, 8, (), "simt"),                 # no TF32
    (torch.bfloat16, 256, 128, 8, (), "simt"),                # Dv off 256
    (torch.bfloat16, 256, 192, 1, (), "simt"),
    (torch.bfloat16, 256, 256, 12, (), "simt"),               # G off 64
    (torch.bfloat16, 256, 256, 8, (0, 8), "simt"),            # a pointer
    (torch.bfloat16, 144, 128, 1, (), "simt"),                # D past 128
    (torch.bfloat16, 128, 256, 1, (), "simt"),                # Dv past 128
    (torch.bfloat16, 80, 80, 3, (), "simt"),                  # G off 64
    (torch.float16, 64, 64, 128, (), "simt"),
    (torch.bfloat16, 80, 80, 1, (0, 8), "simt"),              # a pointer
    (torch.float16, 80, 80, 1, (256, 24), "simt"),            # a stride
])
def test_attention_bwd_route_rule(dtype, d, dv, g, aligned, route):
    assert tplan.attention_bwd_route(dtype, d, dv, g, *aligned) == route


def test_attention_bwd_route_over_the_sweep():
    """dtype x D x Dv x G x alignment against the rule as stated."""
    for dt, d, dv, g, off in itertools.product(
            (torch.float32, torch.float16, torch.bfloat16),
            (8, 16, 48, 64, 72, 80, 128, 144, 192, 256),
            (16, 24, 48, 80, 96, 128, 160, 192, 256),
            (1, 2, 3, 8, 16, 64, 96), (0, 2, 16)):
        want = ("wgmma" if dt != torch.float32
                and ((((16 <= d <= 128 and d % 16 == 0) or d == 192)
                      and 16 <= dv <= 128 and dv % 16 == 0)
                     or d == dv == 256)
                and g in (1, 2, 8, 16, 64) and off % 16 == 0 else "simt")
        assert tplan.attention_bwd_route(dt, d, dv, g, 1 << 20, off) == want


def test_backward_wrapper_counts_per_route():
    """The gradient's wrapper uses the planner's rule and counts one launch
    a call on its route, keyed by the C side's route codes; on CPU tensors
    it takes the plain version and counts nothing."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    bwd = fa.flash_attention_bwd_kernel
    assert fa.attention_bwd_route is tplan.attention_bwd_route
    assert set(bwd.route_launches) == set(_build.ROUTE_CODES) \
        == {"simt", "wgmma"}
    before = (bwd.launches, dict(bwd.route_launches))
    q = torch.randn(1, 8, 2, 80, dtype=torch.bfloat16)
    with use_default(DiompContext(device="cpu")):
        o, lse = fa.flash_attention_plain(q, q, q, return_lse=True)
        bwd(q, q, q, o, o, lse)
    assert (bwd.launches, bwd.route_launches) == before


def test_backward_tiles_match_the_cuda_source():
    from repro_torch.kernels import _build
    # the tensor-core route's shared pieces live in attention_bwd.cuh
    bw = {**_defines("attention_bwd.cuh"), **_defines("flash_attention_bwd.cu")}
    assert bw["BWD_BQ"] == tplan.FLASH_BQ == 64
    assert bw["BWD_TC_STAGES"] == tplan.BWD_TC_STAGES
    assert bw["BWD_TC_THREADS"] == tplan.BWD_TC_THREADS == 128 + 32
    text = (CSRC / "flash_attention_bwd.cu").read_text() \
        + (CSRC / "attention_bwd.cuh").read_text()
    # one instance a width the rule admits: W = max(D, Dv), 16 to 128
    inst = {int(w) for w in re.findall(r"launch_bwd_tc<T, (\d+)>", text)}
    assert inst == set(range(16, 129, 16))
    # the ABI's route argument sits between the dtype and the stream
    argtypes = _build.LIBRARIES["flash_attention_bwd"][1][
        "repro_flash_attention_bwd"]
    sig = re.search(r"repro_flash_attention_bwd\(([^)]*)\)", text).group(1)
    assert len(argtypes) == sig.count(",") + 1
    assert sig.replace(" ", "").replace("\n", "").endswith(
        "intdtype,introute,void*stream")
    # two blocks of the widest instance fit an SM's shared memory
    expr = re.search(r"bwd_tc_smem_bytes\(int nbox\) \{\s*return "
                     r"([^;]+);", text).group(1)
    got = eval(" ".join(expr.split()), {
        "nbox": 2, "BWD_TC_STAGES": bw["BWD_TC_STAGES"],
        "BWD_BOX": 64 * 128, "BWD_ROW_STATS": 3 * 64 * 4})
    assert 2 * (got + 1024) <= 233_472


def test_backward_wide_instance_matches_the_cuda_source():
    """The wide instance (D = 192: deepseek-v3's MLA heads): its launch
    width and the planner's, its one instance (dk 192 wide in warpgroup 0,
    dv 128 in warpgroup 1, the dq pass 192 wide over 3 + 2 boxes), and its
    shared memory, ``bwd_tc_wide_smem_bytes`` read from the source,
    against :func:`attention_bwd_wide_smem_bytes`; at kb = vb = nbox the
    same formula is ``bwd_tc_smem_bytes(nbox)``."""
    bw = {**_defines("attention_bwd.cuh"), **_defines("flash_attention_bwd.cu")}
    assert bw["BWD_WIDE_THREADS"] == tplan.BWD_WIDE_THREADS == 2 * 128 + 32
    text = (CSRC / "flash_attention_bwd.cu").read_text() \
        + (CSRC / "attention_bwd.cuh").read_text()
    assert set(re.findall(r"dkdv_wide_kernel<T, (\d+), (\d+)>", text)) \
        == {("192", "128")}
    assert set(re.findall(r"dq_tc_kernel<T, 192, (\d+), (\d+)>", text)) \
        == {("3", "2")}
    assert re.search(r"if \(p\.D == 192\) return launch_bwd_tc_wide<T>",
                     text)
    env = {"BWD_TC_STAGES": bw["BWD_TC_STAGES"], "BWD_BOX": 64 * 128,
           "BWD_ROW_STATS": 3 * 64 * 4}
    wide = " ".join(re.search(
        r"bwd_tc_wide_smem_bytes\(int kb, int vb\) \{\s*return ([^;]+);",
        text).group(1).split())
    narrow = " ".join(re.search(
        r"bwd_tc_smem_bytes\(int nbox\) \{\s*return ([^;]+);",
        text).group(1).split())
    got = eval(wide, {**env, "kb": 3, "vb": 2})
    assert got == tplan.attention_bwd_wide_smem_bytes(3, 2) == 125_480
    assert got <= tplan.SMEM_BUDGET_DEFAULT
    for nbox in (1, 2, 3):
        assert eval(wide, {**env, "kb": nbox, "vb": nbox}) == \
            eval(narrow, {**env, "nbox": nbox}) == \
            tplan.attention_bwd_wide_smem_bytes(nbox, nbox)
    # the C side's rule admits D = 192 beside the narrow widths, Dv as before
    rule = re.search(r"static bool bwd_tc_route_ok\([^{]*\{(.*?)\n\}",
                     text, re.S).group(1)
    assert "D == 192" in rule and "head_ok(Dv)" in rule


def _c_rule(text: str, fn: str):
    """The width and G conditions of the C route rule ``fn`` (its ``if
    (...) return false;`` statements but the pointers' alignment) as a
    Python predicate of (dtype code, D, Dv, G)."""
    body = re.search(r"static bool " + fn + r"\([^{]*\{(.*?)\n\}", text,
                     re.S).group(1)
    conds = [" ".join(c.split()) for c in re.findall(
        r"if \((.*?)\)\s*return false;", body, re.S)
        if "reinterpret_cast" not in c]
    expr = " or ".join(f"({c})" for c in conds)
    for c_op, py in (("&&", " and "), ("||", " or "), ("!=", " ~NE~ "),
                     ("!", " not "), ("~NE~", "!=")):
        expr = expr.replace(c_op, py)

    def head_ok(x):
        return 16 <= x <= 128 and x % 16 == 0

    def admits(dtype, D, Dv, G):
        return not eval(expr, {"head_ok": head_ok, "dtype": dtype, "D": D,
                               "Dv": Dv, "G": G, "kBF16": 2, "kF16": 1})
    return admits


def test_backward_w256_instance_matches_the_cuda_source():
    """The 256-wide instances of rows 10 and 14 (D = Dv = 256: four
    consumer warpgroups on ``attention_bwd.cuh``'s pair step, no producer
    warp): the block's threads, ``bwd_w_smem_bytes`` read from the source
    against :func:`attention_bwd_w256_smem_bytes` and the card's 232,448
    bytes a block (both rows launch it as it is), the dispatches that pick
    them, and both C rules against the planner's over a sweep of widths
    and G."""
    from repro_torch.kernels.ring_attention import fused
    bw = _defines("attention_bwd.cuh")
    assert bw["BWD_W_THREADS"] == tplan.BWD_W_THREADS == 4 * 128
    head = (CSRC / "attention_bwd.cuh").read_text()
    flash = (CSRC / "flash_attention_bwd.cu").read_text()
    ring = (CSRC / "ring_attention_bwd.cu").read_text()
    expr = " ".join(re.search(r"bwd_w_smem_bytes\(\) \{\s*return ([^;]+);",
                              head).group(1).split())
    loads = int(re.search(r"constexpr int BWD_W_LOADS = (\d+);",
                          head).group(1))
    got = eval(expr, {"BWD_TC_STAGES": bw["BWD_TC_STAGES"],
                      "BWD_BOX": 64 * 128, "BWD_ROW_STATS": 3 * 64 * 4,
                      "BWD_W_LOADS": loads})
    assert got == tplan.attention_bwd_w256_smem_bytes() == 232_104
    assert got <= tplan.SMEM_BUDGET_DEFAULT == 232_448
    assert re.search(r"smem = W == 256 \? bwd_w_smem_bytes\(\)", ring)
    assert "const int smem = bwd_w_smem_bytes();" in flash
    assert re.search(r"if \(p\.D == 256\) return launch_bwd_tc_w256<T>",
                     flash)
    assert re.search(r"if \(p\.D == 256\) return launch_tc<T, 256>", ring)
    rules = ((_c_rule(flash, "bwd_tc_route_ok"), tplan.attention_bwd_route),
             (_c_rule(ring, "ring_bwd_tc_route_ok"), fused.ring_bwd_route))
    for (c_rule, rule), d, dv, g in itertools.product(
            rules, (16, 64, 80, 128, 144, 192, 240, 256),
            (16, 64, 128, 192, 256), (1, 8, 12, 64)):
        for dt, code in ((torch.bfloat16, 2), (torch.float16, 1),
                         (torch.float32, 0)):
            assert c_rule(code, d, dv, g) == (rule(dt, d, dv, g) == "wgmma")


def test_attention_tiles_match_the_cuda_sources():
    at = _defines("attention.cuh")
    assert at["ATT_BQ"] == tplan.FLASH_BQ == 64
    assert at["ATT_TC_BK"] == tplan.ATT_TC_BK == 64
    assert at["ATT_TC_STAGES"] == tplan.ATT_TC_STAGES
    assert at["ATT_TC_THREADS"] == tplan.ATT_TC_THREADS == 128 + 32
    # the launch's dynamic shared memory, att_tc_smem_bytes, evaluated at
    # every pair of widths the rule admits (whole 64-column boxes: 80 and
    # 48 take two and one)
    text = (CSRC / "attention.cuh").read_text()
    expr = re.search(r"att_tc_smem_bytes\(int D, int Dv\) \{\s*return "
                     r"([^;]+);", text).group(1)
    widths = [*range(16, 129, 16), 256]
    for d, dv in itertools.product(range(16, 257, 16), widths):
        assert tplan.attention_route(torch.bfloat16, d, dv, 1) == "wgmma"
        got = eval(" ".join(expr.split()), {
            "D": d, "Dv": dv, "ATT_TC_STAGES": at["ATT_TC_STAGES"]})
        assert got == tplan.OverlapPlanner.attention_tc_stage_bytes(d, dv)
        assert got <= tplan.SMEM_BUDGET_DEFAULT
    # D = Dv = 80: q two boxes, each stage two of k and two of v
    assert tplan.OverlapPlanner.attention_tc_stage_bytes(80, 80) == \
        1024 + 2 * 8192 + 2 * (2 + 2) * 8192 + 6 * 8
    assert tplan.OverlapPlanner.attention_tc_stage_bytes(80, 48) == \
        1024 + 2 * 8192 + 2 * (2 + 1) * 8192 + 6 * 8
    # MLA's D = 192, Dv = 128: q three boxes, each stage three of k and
    # two of v
    assert tplan.OverlapPlanner.attention_tc_stage_bytes(192, 128) == \
        1024 + (3 + 2 * (3 + 2)) * 8192 + 48 == 107_568
    # D = Dv = 256: q 32 KiB + 2 x (32 + 32) KiB, the alignment slack and
    # six barriers; one block an SM fits
    big = tplan.OverlapPlanner.attention_tc_stage_bytes(256, 256)
    assert big == 160 * 1024 + 1024 + 6 * 8 <= tplan.SMEM_BUDGET_DEFAULT
    # the head dims the rule sends to the tensor cores are the instances
    # both kernels have
    for src in ("flash_attention.cu", "ring_attention.cu"):
        inst = {int(w) for w in re.findall(r"launch_tc<T, (\d+)>",
                                           (CSRC / src).read_text())}
        assert inst == set(widths), src


@pytest.mark.parametrize("dtype,d,f,aligned,route", [
    (torch.bfloat16, 4096, 1536, (0, 256, 1 << 20), "wgmma"),  # qwen3-moe
    (torch.float16, 4096, 1536, (16, 32), "wgmma"),
    (torch.bfloat16, 256, 128, (), "wgmma"),                   # the checks
    (torch.bfloat16, 64, 64, (), "wgmma"),
    (torch.float32, 4096, 1536, (0, 256), "simt"),             # no TF32
    (torch.float32, 256, 128, (), "simt"),
    (torch.bfloat16, 4096, 1500, (), "simt"),                  # f off 64
    (torch.float16, 200, 128, (), "simt"),                     # d off 64
    (torch.bfloat16, 32, 64, (), "simt"),                      # d under 64
    (torch.bfloat16, 4096, 1536, (0, 8), "simt"),              # a pointer
    (torch.bfloat16, 4096, 1536, (256, 24), "simt"),           # a stride
])
def test_expert_route_rule(dtype, d, f, aligned, route):
    assert tplan.expert_route(dtype, d, f, *aligned) == route


def test_expert_route_over_the_sweep():
    """dtype x d x f x alignment against the rule as stated."""
    for dt, d, f, off in itertools.product(
            (torch.float32, torch.float16, torch.bfloat16),
            (32, 64, 96, 128, 200, 4096), (48, 64, 96, 1536, 1600),
            (0, 2, 8, 16)):
        want = ("wgmma" if dt != torch.float32 and d % 64 == 0
                and f % 64 == 0 and off % 16 == 0 else "simt")
        assert tplan.expert_route(dt, d, f, 1 << 20, off) == want


def test_both_expert_wrappers_share_the_route_rule():
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_dispatch import fused, kernel
    assert kernel.expert_route is fused.expert_route is tplan.expert_route
    for wrapper in (kernel.expert_mlp, fused.fused_moe_dispatch_kernel):
        assert set(wrapper.route_launches) == set(_build.ROUTE_CODES) \
            == {"simt", "wgmma"}
    before = dict(kernel.expert_mlp.route_launches)
    x = torch.randn(2, 4, 64, dtype=torch.bfloat16)
    w = torch.randn(2, 64, 64, dtype=torch.bfloat16)
    kernel.expert_mlp(x, w, w, w, torch.tensor([0, 3], dtype=torch.int32))
    assert kernel.expert_mlp.route_launches == before   # the CPU counts none


def test_expert_tiles_match_the_cuda_sources():
    ex = _defines("expert_mlp.cuh")
    assert (ex["EX_TC_BM"], ex["EX_TC_BK"]) == tplan.EX_TC_TILE == (64, 64)
    assert ex["EX_TC_BR"] == tplan.EX_TC_BR == max(tplan.EX_TC_NS)
    assert ex["EX_TC_STAGES"] == tplan.EX_TC_STAGES >= 3
    assert ex["EX_TC_THREADS"] == tplan.EX_TC_THREADS == 128 + 32
    text = (CSRC / "expert_mlp.cuh").read_text()
    # the launch's dynamic shared memory, ex_tc_smem_bytes, evaluated for
    # the gate/up pass (two weight tiles a stage) and the down pass (one)
    expr = re.search(r"ex_tc_smem_bytes\(int mats\) \{\s*return "
                     r"([^;]+);", text).group(1)
    for mats in (1, 2):
        got = eval(" ".join(expr.split()), {
            "mats": mats, "EX_TC_STAGES": ex["EX_TC_STAGES"],
            "EX_TC_BR": ex["EX_TC_BR"]})
        assert got == tplan.OverlapPlanner.expert_tc_smem_bytes(mats)
        assert got <= tplan.SMEM_BUDGET_DEFAULT
    # six stages of two 8 KiB weight tiles and a 16 KiB row tile, the
    # alignment slack and twelve barriers: one block an SM fits
    big = tplan.OverlapPlanner.expert_tc_smem_bytes(2)
    assert big == 6 * 32 * 1024 + 1024 + 12 * 8 <= tplan.SMEM_BUDGET_DEFAULT
    # the instances the tile switch and the wgmma wrappers have, and the
    # rule that picks one (ex_tc_n) against the planner's
    tiles = set(re.findall(r"ex_tc_tile<T, (\d+), MATS>", text))
    specs = set(re.findall(r"EX_MMA_SPEC\((\d+)\)\n", text))
    shapes = set(re.findall(r'"m64n(\d+)k16"', text))
    want = {str(n) for n in tplan.EX_TC_NS}
    assert tiles == specs == shapes == want
    rule = re.search(r"ex_tc_n\(int rows\) \{\s*return ([^;]+);",
                     text).group(1)
    steps = [int(a) for a, b in re.findall(r"rows <= (\d+) \? (\d+)", rule)]
    assert steps == list(tplan.EX_TC_NS[:-1])
    for rows in range(0, tplan.EX_TC_BR + 1):
        n = next((s for s in steps if rows <= s), tplan.EX_TC_NS[-1])
        assert n == tplan.expert_tile_n(rows) >= rows


@pytest.mark.parametrize("C", [2, 20, 256])
@pytest.mark.parametrize("pattern", ["none", "one", "full", "mixed"])
def test_expert_live_tiles_cover_every_live_item_once(C, pattern):
    """The mirror of the card's work list: at the decode (C = 2) and chunk
    (C = 256) shapes, and C = 20, with zero, one and C live rows, every
    live (problem, row) falls in exactly one item of each column tile, no
    item covers a row past its count, and no problem without live rows has
    an item."""
    problems, cols = 12, 1536
    live = {"none": [0] * problems, "one": [1] * problems,
            "full": [C] * problems,
            "mixed": [0, 1, C, C + 5, -3, min(C, 129), 0, 7, C, 1, 0,
                      C // 2]}[pattern]
    clamp = [min(max(n, 0), C) for n in live]
    tiles = tplan.expert_live_tiles(live, C)
    mt = -(-C // tplan.EX_TC_BR)
    assert list(tiles) == sorted(tiles)                    # problem order
    assert len(tiles) == sum(-(-n // tplan.EX_TC_BR) for n in clamp)
    items = tplan.expert_items(live, C, cols)
    assert len(items) == len(tiles) * (cols // 64)
    # the column tile fastest: blocks side by side share the weight rows
    assert [it[3] for it in items] == list(range(cols // 64)) * len(tiles)
    covered = []
    for p, row0, rows, col in items:
        assert 1 <= rows <= tplan.EX_TC_BR and row0 % tplan.EX_TC_BR == 0
        assert tplan.expert_tile_n(rows) >= rows
        assert (p * mt + row0 // tplan.EX_TC_BR) in tiles
        covered += [(p, r, col) for r in range(row0, row0 + rows)]
    want = [(p, r, col) for col in range(cols // 64)
            for p in range(problems) for r in range(clamp[p])]
    assert sorted(covered) == sorted(want)
    assert len(covered) == len(set(covered))               # once each
    # the list's length bound, as the wrappers allocate it
    assert 1 + len(tiles) <= tplan.expert_list_len(problems, C)
    ex = (CSRC / "expert_mlp.cuh").read_text()
    assert "return 1 + problems * ((C + EX_TC_BR - 1) / EX_TC_BR);" in ex


@pytest.mark.parametrize("blocks,keys,splits", [
    (8, 4096, 33),      # glm4-9b / paligemma-3b decode: 2 ranks x 4 slots
    (16, 4096, 17),     # qwen3-moe decode: 2 kv heads a rank
    (128, 4096, 3),     # zamba2 decode: 16 kv heads a rank
    (8, 100, 2),        # no more runs than key tiles
    (3, 1000, 16),
    (1, 64, 1),
    (132, 4096, 1),     # the grid already fills the card
    (256, 4096, 1),     # glm4-9b chunk: 128 tiles x 2 ranks
    (4096, 2000, 1),    # a prefill
])
def test_key_splits_rule(blocks, keys, splits):
    got = tplan.plan_key_splits(blocks, keys)
    assert got == splits
    if splits > 1:      # a decode grid covers the card, about twice at most
        assert blocks * got >= tplan.SMS_DEFAULT or got == -(-keys // 64)
        assert blocks * got < 2 * tplan.SMS_DEFAULT + blocks
    assert tplan.plan_key_splits(blocks, keys, sms=blocks) == 1


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 33])
def test_key_split_tiles_cover_every_tile_once(splits):
    for tiles in range(0, 70):
        runs = tplan.key_split_tiles(tiles, splits)
        assert len(runs) == splits
        covered = [t for lo, hi in runs for t in range(lo, hi)]
        assert covered == list(range(tiles))            # once, in order
        assert all(lo <= hi for lo, hi in runs)
        sizes = [hi - lo for lo, hi in runs]
        assert max(sizes) - min(sizes) <= 1             # balanced


def test_attention_block_is_fixed_on_the_tensor_core_route():
    p = tplan.OverlapPlanner()
    for dt in (torch.bfloat16, torch.float16):
        assert p.plan_attention_block(8, 8, 64, 64, dt, block=16) == 64
        assert p.plan_attention_block(1, 4096, 256, 256, dt) == 64
        assert p.plan_attention_block(8, 8, 80, 80, dt, block=16) == 64
        assert p.plan_attention_block(8, 8, 80, 48, dt, block=16) == 64
    assert p.plan_attention_block(8, 8, 64, 64, torch.float32, block=16) == 16
    assert p.plan_attention_block(8, 8, 80, 80, torch.float32,
                                  block=16) == 16
    assert p.plan_attention_block(8, 8, 192, 128, torch.bfloat16,
                                  block=16) == 64
    assert p.plan_attention_block(8, 8, 192, 128, torch.float32,
                                  block=16) == 16


def test_resolve_ring_impl_equal():
    for impl in (None, "auto", "host", "fused"):
        assert tplan.resolve_ring_impl(impl) == jplan.resolve_ring_impl(impl)
    with pytest.raises(ValueError):
        tplan.resolve_ring_impl("warp")


def test_plan_slots_matches_reference_pool():
    for ws in (1, 4096, 1 << 20, 1 << 30):
        assert StreamPool(8).plan_slots(ws, 16 << 20) == \
            JStreamPool(8).plan_slots(ws, 16 << 20)


# ---------------------------------------------------------------------------
# the fused step's dispatch: which steps the kernel takes, on which route
# ---------------------------------------------------------------------------


def _route(plan, *, on_card=True, dtype=torch.float32, dim=5, ny=1,
           z_extents=None, halos=None, return_halos=False):
    from repro_torch.kernels.stencil.fused import fused_step_route
    return fused_step_route(on_card=on_card, dtype=dtype, dim=dim, ny=ny,
                            z_extents=z_extents, plan=plan, halos=halos,
                            return_halos=return_halos)


def test_fused_step_route_sends_minimod_to_the_kernel():
    """Minimod's fused fields at 1024³ over nz = 4 (f32, 1-D, symmetric):
    every carried step of its time loop goes to the kernel's carried
    schedule, entering the loop too; a lone step to the single one; the
    CPU to the emulation."""
    from repro_torch.kernels.stencil.fused import Halos
    plan = tplan.OverlapPlanner().plan_halo_slots(256, 1024, 1024,
                                                  torch.float32, 4)
    h = Halos(object(), object())
    assert plan.overlap
    assert _route(plan, halos=h, return_halos=True) == "carried"
    assert _route(plan, return_halos=True) == "carried"
    assert _route(plan, halos=h) == "carried"
    assert _route(plan) == "single"
    assert _route(plan, on_card=False, halos=h, return_halos=True) \
        == "emulation"


@pytest.mark.parametrize("what", ["2-D", "asymmetric", "bf16", "4-D"])
def test_fused_step_route_keeps_the_rest_on_the_emulation(what):
    from repro_torch.kernels.stencil.fused import Halos
    plan = tplan.OverlapPlanner().plan_halo_slots(64, 32, 32,
                                                  torch.float32, 4)
    kw = {"2-D": dict(ny=2), "asymmetric": dict(z_extents=(64, 60, 60, 60)),
          "bf16": dict(dtype=torch.bfloat16), "4-D": dict(dim=4)}[what]
    for carried in (False, True):
        h = Halos(object(), object()) if carried else None
        assert _route(plan, halos=h, return_halos=carried, **kw) \
            == "emulation"


def test_fused_step_route_on_plans_without_overlap():
    """The fallback plan (no interior): given halos are the emulation's,
    a step without them the kernel's single step (``(out, None)`` with
    ``return_halos``); a one-rank ring ignores halos."""
    from repro_torch.kernels.stencil.fused import Halos
    h = Halos(object(), object())
    fallback = tplan.OverlapPlanner().plan_halo_slots(8, 16, 16,
                                                      torch.float32, 4)
    assert not fallback.overlap
    assert _route(fallback, halos=h) == "emulation"
    assert _route(fallback, return_halos=True) == "single"
    one = tplan.OverlapPlanner().plan_halo_slots(64, 16, 16, torch.float32, 1)
    assert _route(one, halos=h, return_halos=True) == "single"


@pytest.mark.parametrize("shape,offset,route", [
    ((4, 1, 256, 1024, 1024), 0, "tma"),     # Minimod at 1024³
    ((4, 1, 12, 10, 12), 0, "tma"),
    ((4, 1, 12, 10, 9), 0, "simt"),          # X off the rule
    ((4, 1, 12, 10, 12), 1, "simt"),         # a pointer off 16 bytes
])
def test_fused_operand_route_is_the_stencil_rule(shape, offset, route):
    """The fused wrapper's route is plan.stencil_route of its operands'
    pointers and byte strides (meta tensors stand in for the card's)."""
    from repro_torch.kernels.stencil import fused
    assert fused.stencil_route is tplan.stencil_route
    n = math.prod(shape)
    dev = "meta" if n > 1 << 20 else "cpu"
    u = torch.empty(n + offset, device=dev)[offset:].view(shape)
    halo = torch.empty(*shape[:2], 4, *shape[3:], device=dev)
    got = fused.operand_route(shape[-1], [u, u.clone(), halo])
    assert got == route
    assert got == tplan.stencil_route(torch.float32, shape[-1], *(
        v for t in (u, halo)
        for v in (t.data_ptr(), *(4 * s for s in t.stride()[:-1]))))
