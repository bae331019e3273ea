#!/usr/bin/env python3
"""Where the linear scan's prefill spends its time on the card, and how the
wave step and the scan compare with another version of their sources.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_split.py [--against DIR]

It builds a copy of ``src/repro_torch/csrc/linear_scan.cu`` whose prefill
kernel adds clock64 accumulators at its pass boundaries (thread 0 of every
block) into ``build/chip_split/``, and prints the share of each pass (the
landing wait, L, R~/Q~ and the tables, A, the in-place scaling, y, S) at
the served shape (BH 256, T 2000, M = N = 64; e^-1 reading the state
before the update, 0.5 after it) for chunks of 16, 32 and 64.  It then
times ``leap``'s TMA route at 1024³ with Z chunks of 16, 24 and 32, and
each of eight calls right after the plain version's frees, with and
without ``torch.cuda.empty_cache()``.

With ``--against DIR`` (a ``csrc`` directory of another version, e.g. the
parent commit's from ``git archive``) it also builds that version's
``wave_step.cu``, ``fused_wave_step.cu`` and ``linear_scan.cu`` as they
are and times both versions in turns (other, this, this, other) with CUDA
events and the profiler's device time: ``leap`` at 1024³ and at Minimod
host mode's (4, 256, 1024, 1024), the fused step's single step at
Minimod's (4, 1, 256, 1024, 1024) (and this version's carried step, which
an entry without it cannot run), the scan's prefill at the served shape
and its decode step; where the other kernels are the earlier one-tile
leap and one-block-a-sequence scan (their pass markers found), their
splits too.

With ``--scan-bwd --against DIR`` it does none of that: it builds DIR's
``linear_scan_bwd.cu`` (the same C entry) and times row 11 of both
versions in turns at the training shape (BH 256, T 1024, M = N = 64),
both readouts, with CUDA events and the profiler's device time.

With ``--expert-bwd --against DIR`` it does none of that either: it builds
DIR's ``expert_mlp_bwd.cu`` and ``moe_dispatch_bwd.cu`` as they are
(through the entries their sources show) and times rows 12 and 13 of both
versions in turns (other, this, this, other) with CUDA events and the
profiler's device time, at qwen3-moe's training shapes (with a ``fill_``
of row 12's dW bytes as a yardstick for the dW pass): row 12 at the a2a
call's x (4, 2, 64, 80, 4096), f 1536, with 13,406 live rows spread at
random over its blocks and with every row live, row 13 at the fused plan's
blocks (2, 2, 2, 64, 512, 4096) with 16,384 live rows (512 tokens a rank,
top-8 of 128 experts); every output is held against the plain version
within 1.6e-2 of its largest magnitude and bit for bit over two launches.
Row 12's passes are separate launches, timed by kernel; row 13's single
cooperative launch is split by pass from clock64 stamps (a copy of each
version's source built into ``build/chip_split/``).

With ``--profiler`` it does none of that either: in a fresh process for
each variant it takes a profiler trace as large as a profiled training
step's (30,000 small launches), then thirty short traces of ten GEMMs
each, as ``chip_smoke.device_ms`` takes them, and prints the launches
each holds: after no large trace, right after one, after a wait of 3 s,
after ``gc.collect()``, with ``TEARDOWN_CUPTI=0`` in the environment,
right after a trace of 1,500 backward passes (autograd's thread), and
after that with 20 ms of work ahead of the calls inside each trace and
20 ms of wait behind them, after 30,000 launches made with no profiler
running, and after those and one empty trace.
Every output is held against the plain version.  Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_split"

HEAD = r'''
__device__ unsigned long long g_acc[16];
extern "C" int split_read(void* h) {
  cudaMemcpyFromSymbol(h, g_acc, sizeof(g_acc));
  return (int)cudaGetLastError();
}
extern "C" int split_reset() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_acc, z, sizeof(z));
  return (int)cudaGetLastError();
}
#define T0() long long t_ = clock64()
#define ACC(i) do { long long n_ = clock64(); \
  if (threadIdx.x == 0 && threadIdx.y == 0) \
  atomicAdd(&g_acc[i], (unsigned long long)(n_ - t_)); t_ = n_; } while (0)
'''

# (anchor, text put before it) of each pass boundary, this version's scan
SPLIT_NOW = (("wait", "L", "prep", "A", "scale", "y", "S"), [
    ("  load_rows(0, 0, 0, CI);\n", None),
    ("    load_part(it, c0, 0);", "ACC(0);"),
    ("    // -- R~, Q~ and the tables", "ACC(1);"),
    ("    load_part(it, c0, 2);", "ACC(2);"),
    ("    // -- R~ exp(L_b) and Q~", "ACC(3);"),
    ("    // -- y = A p + ", "ACC(4);"),
    ("    // -- S <- S exp(L_end)", "ACC(5);"),
    ("    if (owns_s)\n#pragma unroll\n    for (int i = 0; i < 4; ++i)\n"
     "      st4(St + (4 * ty + i) * M4 + 4 * tx,\n"
     "          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));\n  }",
     "AFTER:ACC(6);"),
])
# the earlier leap (one plane tile staged by the threads a plane): staging
# (the loads into the tile and the sync) against the star and the store
SPLIT_EARLIER_LEAP = (("staging", "compute"), [
    ("  for (int k = k0; k < k1; ++k) {\n", "T0();"),
    ("    __syncthreads();\n    if (inside) {", "MID:ACC(0);"),
    ("    __syncthreads();\n#pragma unroll\n    for (int i = 0; i < 2 * R; "
     "++i) q[i] = q[i + 1];", "MID:ACC(1);"),
])
# the same for the earlier scan (one block a sequence, no sub-chunks)
SPLIT_EARLIER = (("stage", "prefix", "A", "transform", "y", "S"), [
    ("  for (int c0 = 0; c0 < T; c0 += C) {\n", "T0();"),
    ("    // -- L: inclusive", "ACC(0);"),
    ("    // -- A[t, s]: every", "ACC(1);"),
    ("    // -- r * exp(Lr) and", "ACC(2);"),
    ("    // -- y = A p + ", "ACC(3);"),
    ("    // -- S <- S exp(", "ACC(4);"),
    ("    __syncthreads();\n  }\n\n  for (int i = tid; i < M * N; i += NT) {",
     "MID:ACC(5);"),
])


def stamped(text: str, marks) -> str:
    """``text`` with the split's header and its accumulators at the marks
    (each anchor must occur once)."""
    text = text.replace('#include "common.cuh"\n',
                        '#include "common.cuh"\n' + HEAD, 1)
    for anchor, put in marks:
        if text.count(anchor) != 1:
            raise ValueError(f"pass marker not found once: {anchor!r}")
        if put is None:
            text = text.replace(anchor, anchor + "  T0();\n")
        elif put.startswith("AFTER:"):
            text = text.replace(anchor, anchor[:-3] + put[6:] + "\n  }")
        elif put.startswith("MID:"):
            rest = anchor[len("    __syncthreads();"):]
            text = text.replace(anchor, "    __syncthreads();\n    "
                                + put[4:] + rest)
        elif put == "T0();":
            indent = anchor[:len(anchor) - len(anchor.lstrip())]
            text = text.replace(anchor, indent + "T0();\n" + anchor)
        else:
            text = text.replace(anchor, "    " + put + "\n" + anchor)
    return text


def stamp(text: str, head_after: str, marks) -> str:
    """``text`` with the split's header after the line ``head_after`` and,
    at each ``(anchor, code, before)``, ``code`` put before (or after) the
    anchor, which must occur once."""
    text = text.replace(head_after, head_after + HEAD, 1)
    for anchor, code, before in marks:
        if text.count(anchor) != 1:
            raise ValueError(f"pass marker not found once: {anchor!r}")
        text = text.replace(anchor, code + anchor if before
                            else anchor + code)
    return text


# row 13's pass split: this version (the landing of the packed rows and
# the puts, A, B, C) and the padded-block version (its puts, lists and
# returns, then A, B, C summed over the ring's offsets); each segment runs
# to the grid barrier after it, so it holds the wait for the slowest block
ROW13_SPLIT = ("landing", "A", "B", "C")
ROW13_MARKS = {
    "packed": [("  // -- the packed layout's metadata", "  T0();\n", True),
               ("    // -- pass A\n", "    ACC(0);\n", True),
               ("    // -- pass B\n", "    ACC(1);\n", True),
               ("  // -- pass C", "  ACC(2);\n", True),
               ("  // -- end\n", "  ACC(3);\n", True)],
    "padded": [("  const ExbTcSmem sm = exb_smem_init(smem);\n"
                "  cg::grid_group grid = cg::this_grid();\n", "  T0();\n",
                False),
               ("    exb_tc_rows_pass<T>(sm, pipe, list, a.C,", "    ACC(0);\n",
                True),
               ("    if (threadIdx.x < EX_TC_CONSUMERS)\n"
                "      ex_zero_dead_rows<T>(NW,", "    ACC(1);\n", True),
               ("  });\n  exb_tc_dw_pass<T>(sm, pipe, NW,", "    ACC(2);\n",
                True),
               ("                    static_cast<T*>(a.dwd));\n", "  ACC(3);\n",
                False)],
}


def build(torch, cs, build_mod, name: str, text: str, src_dir: Path,
          tag: str):
    """``text`` as ``name``.cu (beside ``src_dir``'s headers) into a
    ctypes library under build/chip_split/<tag>/."""
    out = OUT / tag
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src_dir, out)
    (out / f"{name}.cu").write_text(text)
    so = out / f"lib{name}.so"
    res = subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o",
                          str(so), str(out / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {tag}/{name}.cu:\n"
                           + res.stdout + res.stderr)
    for func, regs, spills in cs.ptxas_summary(res.stdout + res.stderr):
        print(f"  {tag}/{name}: {func}: {regs} registers, {spills}")
    lib = ctypes.CDLL(str(so))
    fns = build_mod.LIBRARIES[name][1]
    if name == "fused_wave_step" and "repro_fused_wave_step_carried" \
            not in text:
        # the earlier entry: no Z chunk, no route code, no carried entry
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fns = {"repro_fused_wave_step": [P, P, P, F, P, P] + [I] * 5
               + [F, P]}
    for fn, argt in fns.items():
        argt = list(argt)
        if name not in ("fused_wave_step", "linear_scan_bwd") \
                and "int route" not in text:
            del argt[-2]             # an entry that takes no route code
        if name in ("expert_mlp_bwd", "moe_dispatch_bwd") \
                and "int tiles" not in text:
            del argt[-4]             # the padded layout's: no tile bound
        getattr(lib, fn).argtypes = argt
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def scan_inputs(torch, g, BH, T, decay, with_s0):
    dev = "cuda"
    p, q, r = (torch.randn(BH, T, 64, generator=g, device=dev) * 0.5
               for _ in range(3))
    a = torch.full((BH, T, 64), decay, device=dev)
    s0 = torch.randn(BH, 64, 64, generator=g, device=dev) if with_s0 \
        else None
    return p, q, a, r, s0


def scan_call(torch, lib, ops, pre, chunk, route):
    """A closure launching ``lib``'s scan on ``ops`` into fresh outputs
    (``route`` None: an entry without route codes)."""
    p, q, a, r, s0 = ops
    BH, T, M = p.shape
    y = torch.empty(BH, T, M, device="cuda")
    sf = torch.empty(BH, M, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tail = (() if route is None else (route,)) + (stream,)

    def call():
        st = lib.repro_linear_scan(
            p.data_ptr(), q.data_ptr(), a.data_ptr(), r.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sf.data_ptr(), BH, T, M, 64, min(chunk, T), int(pre), *tail)
        if st != 0:
            raise RuntimeError(f"scan launch failed: {st}")
        return y, sf
    return call


def split(torch, cs, lib, call, names) -> str:
    acc = (ctypes.c_ulonglong * 16)()
    call()
    torch.cuda.synchronize()
    lib.split_reset()
    ms = cs.cuda_ms(torch, call, 5, warmup=0)
    lib.split_read(acc)
    total = sum(acc[i] for i in range(len(names)))
    return f"{ms:.4f} ms; " + ", ".join(
        f"{n} {100 * acc[i] / total:.1f} %" for i, n in enumerate(names))


def fused_step(torch, cs, k, g, lib, carried_abi: bool, turns) -> None:
    """The fused step at Minimod's (4, 1, 256, 1024, 1024), scalar c2:
    another version's single step (its entry as it is) against this one's
    in turns, then this version's carried step alone; each output held
    against the plain version."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.kernels.stencil import fused as st_fused
    from repro_torch.launch.mesh import RankMesh
    nz, zl, n, R = 4, 256, 1024, 4
    u = torch.randn(nz, 1, zl, n, n, generator=g, device="cuda") * 0.1
    up = torch.randn(nz, 1, zl, n, n, generator=g, device="cuda") * 0.1
    plan = OverlapPlanner().plan_halo_slots(zl, n, n, torch.float32, nz)
    want = k.fused_step_plain(u, up, 0.1, dx=1.0)
    lim = 2e-5 * float(want.abs().max())
    out = torch.empty_like(u)
    win = torch.empty(nz, 2, R, n, n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # this version's entry takes the put items' counts (zeroed each call),
    # a Z chunk and a route; the earlier one none of them
    sync = torch.zeros(nz + 1, dtype=torch.int32, device="cuda")
    mid, tail = ((sync.data_ptr(),), (32, 1.0, 1)) if carried_abi \
        else ((), (1.0,))

    def old():
        sync.zero_()
        st = lib.repro_fused_wave_step(
            u.data_ptr(), up.data_ptr(), None, 0.1, out.data_ptr(),
            win.data_ptr(), *mid, nz, zl, n, n, int(plan.overlap), *tail,
            stream)
        if st != 0:
            raise RuntimeError(f"other fused step launch failed: {st}")

    def new():
        return k.fused_wave_step_kernel(u, up, 0.1, plan=plan)

    old()
    cs.check(cs.max_err(torch, out, want) <= lim, "other fused step")
    cs.check(cs.max_err(torch, new(), want) <= lim, "fused step")
    del want
    turns("fused step single (4, 1, 256, 1024, 1024)", new, old, 5)
    with use_default(DiompContext(mesh=RankMesh(("z", "y"), (nz, 1)),
                                  device="cuda")):
        h = st_fused.exchange_halos(u, DiompGroup(("z",), name="z"))

    def carried():
        return k.fused_wave_step_kernel(u, up, 0.1, plan=plan, halos=h,
                                        return_halos=True)

    got, want = carried(), k.fused_step_carried_plain(u, up, 0.1, h, dx=1.0)
    cs.check(cs.max_err(torch, got[0], want[0]) <= lim, "carried fused step")
    del got, want
    print(f"fused step carried: this {cs.cuda_ms(torch, carried, 5):.4f} ms "
          f"(device {cs._ms(cs.device_ms(torch, carried, 5, cs.FUSED_KERNELS), 4)})")
    del u, up, out, win, h
    torch.cuda.empty_cache()


def scan_bwd_turns(torch, cs, _build, k, g, other_dir: Path) -> None:
    """Row 11 at the training shape, this version against ``other_dir``'s
    ``linear_scan_bwd.cu``, each within 2e-4 of the plain version's
    gradients, in turns (other, this, this, other) under both readouts."""
    lib = build(torch, cs, _build, "linear_scan_bwd",
                (other_dir / "linear_scan_bwd.cu").read_text(), other_dir,
                "other_linear_scan_bwd")
    BH, T, M, N = 256, cs.TRAIN_SEQ, 64, 64
    p, q, a, r = cs._scan_inputs(torch, g, BH, T, M, N, None)
    dy = torch.randn(BH, T, M, generator=g, device="cuda")
    args = (p, q, a, r, None, dy, None)
    outs = [torch.empty_like(x) for x in (p, q, q, q)]
    ds0 = torch.empty(BH, M, N, device="cuda")
    states = torch.empty(BH, -(-T // 16), 64, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for pre in (True, False):
        def old():
            st = lib.repro_linear_scan_bwd(
                p.data_ptr(), q.data_ptr(), a.data_ptr(), r.data_ptr(), None,
                dy.data_ptr(), None, *(o.data_ptr() for o in outs),
                ds0.data_ptr(), states.data_ptr(), BH, T, M, N, int(pre),
                stream)
            if st != 0:
                raise RuntimeError(f"other scan backward failed: {st}")
            return (*outs, ds0)

        def new():
            return k.linear_scan_bwd_kernel(*args, readout_pre=pre)

        want = k.linear_scan_bwd_plain(*args, readout_pre=pre)
        err_new = cs._scan_bwd_err(torch, new(), want)
        err_old = cs._scan_bwd_err(torch, old(), want)
        cs.check(max(err_new, err_old) <= 2e-4, "scan backward against plain")
        del want
        t = [cs.cuda_ms(torch, old, 5), cs.cuda_ms(torch, new, 5),
             cs.cuda_ms(torch, new, 5), cs.cuda_ms(torch, old, 5)]
        dn = cs.device_ms(torch, new, 10, cs.SCAN_BWD_KERNELS)
        do = cs.device_ms(torch, old, 10, cs.SCAN_BWD_KERNELS)
        print(f"scan backward at ({BH}, {T}, {M}, {N}), pre {pre} (relative "
              f"err {err_new:.3g} / {err_old:.3g}): this {t[1]:.4f} / "
              f"{t[2]:.4f} ms (device {cs._ms(dn, 4)}), other {t[0]:.4f} / "
              f"{t[3]:.4f} ms (device {cs._ms(do, 4)})")


def _a2a_counts(torch, g, G, S, E, C, live):
    """(G, S, E) int32 counts summing to ``live``: uniform draws scaled,
    then single entries moved by one until the sum is ``live``."""
    c = torch.rand(G, S, E, generator=g, device="cuda")
    c = (c / c.sum() * live).round().clamp(0, C).to(torch.int32).flatten()
    i = 0
    while int(c.sum()) != live:
        step = 1 if int(c.sum()) < live else -1
        if 0 <= int(c[i]) + step <= C:
            c[i] += step
        i = (i + 1) % c.numel()
    return c.view(G, S, E)


def _other_row12(torch, lib, x, ws, dy, counts):
    """A closure launching the padded-block version of row 12 (its entry
    as the parent's source shows it) into fresh outputs."""
    from repro_torch.kernels._build import DTYPE_CODES, ROUTE_CODES
    from repro_torch.kernels.moe_dispatch.kernel import rank_strided
    G, S_, E, C, d = x.shape
    f = ws[0].shape[-1]
    (wg, sg), (wu, su), (wd, sd) = (rank_strided(w) for w in ws)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        dx = torch.empty_like(x)
        dw = [torch.empty_like(w) for w in ws]
        scratch = torch.empty(3 * G * S_ * E * C * f, dtype=x.dtype,
                              device="cuda")
        work = torch.empty(1 + G * S_ * E * -(-C // 64), dtype=torch.int32,
                           device="cuda")
        st = lib.repro_expert_mlp_bwd(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            dy.data_ptr(), counts.data_ptr(), dx.data_ptr(),
            *(w.data_ptr() for w in dw), scratch.data_ptr(), work.data_ptr(),
            sg, su, sd, G, S_, E, C, d, f, DTYPE_CODES[x.dtype],
            ROUTE_CODES["wgmma"], stream)
        if st != 0:
            raise RuntimeError(f"other expert_mlp_bwd failed: {st}")
        return (dx, *dw)
    return call


def _other_row13(torch, lib, buf, ws, counts, dfull, group, plan):
    """The same for row 13: the padded blocks, slots and scratch, in the
    kernel's ring-last layout (the group's rank dim is last of the mesh
    here, so buf's layout is it)."""
    from repro_torch.kernels._build import DTYPE_CODES, ROUTE_CODES
    from repro_torch.kernels.moe_dispatch import fused
    from repro_torch.kernels.moe_dispatch.kernel import rank_strided
    ep, E_loc, C = plan.ep, plan.E_loc, plan.cap_pad
    d, f = buf.shape[-1], ws[0].shape[-1]
    G = buf.numel() // (ep * ep * E_loc * C * d)
    (wg, sg), (wu, su), (wd, sd) = (rank_strided(w) for w in ws)
    sched = fused._schedule_table(plan, buf.device)
    slots = max(ep - 1, 1)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        dbuf = torch.empty_like(buf)
        dw = [torch.empty_like(w) for w in ws]
        stages = [torch.empty(G, ep, slots, E_loc, C, d, dtype=buf.dtype,
                              device="cuda") for _ in range(3)]
        scratch = torch.empty(3 * G * ep * ep * E_loc * C * f,
                              dtype=buf.dtype, device="cuda")
        work = torch.empty(ep * (1 + G * ep * E_loc * -(-C // 64)),
                           dtype=torch.int32, device="cuda")
        st = lib.repro_moe_dispatch_bwd(
            buf.data_ptr(), dfull.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), counts.data_ptr(), dbuf.data_ptr(),
            *(w.data_ptr() for w in dw), *(s.data_ptr() for s in stages),
            scratch.data_ptr(), sched.data_ptr(), work.data_ptr(), sg, su, sd,
            sched.shape[0], G, ep, slots, E_loc, C, d, f,
            DTYPE_CODES[buf.dtype], ROUTE_CODES["wgmma"], stream)
        if st != 0:
            raise RuntimeError(f"other moe_dispatch_bwd failed: {st}")
        return (dbuf, *dw)
    return call


def _row13_split(torch, cs, lib, call) -> str:
    """Shares of row 13's passes from a stamped build's clock64 sums."""
    acc = (ctypes.c_ulonglong * 16)()
    call()
    torch.cuda.synchronize()
    lib.split_reset()
    call()
    torch.cuda.synchronize()
    lib.split_read(acc)
    total = sum(acc[i] for i in range(len(ROW13_SPLIT)))
    return ", ".join(f"{n} {100 * acc[i] / total:.1f} %"
                     for i, n in enumerate(ROW13_SPLIT))


def expert_bwd_turns(torch, cs, _build, k, g, other_dir: Path) -> None:
    """Rows 12 and 13 at the training shapes, this version against
    ``other_dir``'s sources, each held against the plain version and bit
    for bit over two launches, timed in turns (other, this, this,
    other)."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh
    texts = {n: (other_dir / f"{n}.cu").read_text()
             for n in ("expert_mlp_bwd", "moe_dispatch_bwd")}
    other = {n: build(torch, cs, _build, n, t, other_dir, f"other_{n}")
             for n, t in texts.items()}
    bf16, tol = torch.bfloat16, 1.6e-2

    def turns(label, new, old, names, reps=3):
        t = [cs.cuda_ms(torch, old, reps), cs.cuda_ms(torch, new, reps),
             cs.cuda_ms(torch, new, reps), cs.cuda_ms(torch, old, reps)]
        dn = cs.device_ms(torch, new, reps, names)
        do = cs.device_ms(torch, old, reps, names)
        print(f"{label}: this {t[1]:.3f} / {t[2]:.3f} ms (device "
              f"{cs._ms(dn, 3)}), other {t[0]:.3f} / {t[3]:.3f} ms (device "
              f"{cs._ms(do, 3)})", flush=True)
        return dn, do

    # row 12 at the a2a call, 13,406 live rows and every row live
    G, S_, E, C, d, f = 4, 2, 64, 80, 4096, 1536
    for live in (13_406, G * S_ * E * C):
        counts = _a2a_counts(torch, g, G, S_, E, C, live)
        x, ws, dy, _ = cs._bwd_case(torch, g, G, S_, E, C, d, f, bf16,
                                    counts)
        new = lambda: k.expert_mlp_bwd(x, *ws, dy, counts)  # noqa: E731
        old = _other_row12(torch, other["expert_mlp_bwd"], x, ws, dy, counts)
        want = k.expert_mlp_bwd_plain(x, *ws, dy, counts)
        tag = (f"row 12 {tuple(x.shape)}, {live} live rows (weight sets by "
               f"packed tiles {cs._tiles_by_set(torch, counts.sum(1))})")
        errs = [cs._bwd_close(torch, fn(), want, fn(), tol, f"{tag} {who}")
                for who, fn in (("this", new), ("other", old))]
        del want
        torch.cuda.empty_cache()
        print(f"{tag}: relative err this {errs[0]:.3g}, other "
              f"{errs[1]:.3g}", flush=True)
        turns(tag, new, old, cs.EXPERT_BWD_KERNELS)
        for who, fn, src in (
                ("this", new, (_build.CSRC / "expert_mlp_bwd.cu").read_text()),
                ("other", old, texts["expert_mlp_bwd"])):
            by = {n: cs.device_ms(torch, fn, 3, (n,))
                  for n in cs.EXPERT_BWD_KERNELS[1:] if n in src}
            print(f"  {who} by kernel: " + ", ".join(
                f"{n} {cs._ms(v, 4)}" for n, v in by.items() if v),
                flush=True)
        del x, ws, dy, counts
        torch.cuda.empty_cache()

    # a yardstick for pass C, which writes each dW once: one fill_ of as
    # many bytes as row 12's three dW at this call
    dw_bytes = torch.empty(3 * G * E * d * f, dtype=bf16, device="cuda")
    print(f"fill_ of {dw_bytes.numel() * 2 / 1e9:.3f} GB (row 12's dW): "
          f"{cs.cuda_ms(torch, lambda: dw_bytes.fill_(0), 5):.3f} ms",
          flush=True)
    del dw_bytes
    torch.cuda.empty_cache()

    # row 13 at the fused training plan
    mesh = RankMesh(("data", "model"), (2, 2))
    group = DiompGroup(("model",), name="ep")
    t_loc, kk, E_all = 512, 8, 128
    plan = OverlapPlanner().plan_alltoall(t_loc, d, kk, E_all, 2, bf16)
    logits = (torch.randn(2, 2, t_loc, E_all, generator=g, device="cuda")
              + 2.0 * torch.randn(E_all, generator=g, device="cuda"))
    top_e = logits.topk(kk, dim=-1).indices
    counts = torch.nn.functional.one_hot(top_e, E_all).sum((-3, -2)) \
        .to(torch.int32).view(2, 2, plan.ep, plan.E_loc)
    lead = tuple(counts.shape[:-1])
    livem = (torch.arange(plan.cap_pad, device="cuda")
             < counts[..., None])[..., None]
    buf = (torch.randn(*lead, plan.E_loc, plan.cap_pad, d, generator=g,
                       device="cuda") * livem).to(bf16)
    dfull = (torch.randn(buf.shape, generator=g, device="cuda")
             * livem).to(bf16)
    ws = [(torch.randn(2, 2, plan.E_loc, a, b, generator=g, device="cuda")
           * a ** -0.5).to(bf16) for a, b in ((d, f), (d, f), (f, d))]
    del livem
    dctx = DiompContext(mesh=mesh, device="cuda")
    with use_default(dctx):
        new = lambda: k.fused_dispatch_bwd_kernel(  # noqa: E731
            buf, *ws, counts, dfull, group, plan=plan)
        old = _other_row13(torch, other["moe_dispatch_bwd"], buf, ws, counts,
                           dfull, group, plan)
        parts = []
        for e0 in range(0, plan.E_loc, cs.MLA_PLAIN_EXPERTS):
            sl = slice(e0, e0 + cs.MLA_PLAIN_EXPERTS)
            parts.append(k.fused_dispatch_bwd_plain(
                buf[..., sl, :, :], *(w[..., sl, :, :] for w in ws),
                counts[..., sl], dfull[..., sl, :, :], group))
        want = [torch.cat(p, dim=-3) for p in zip(*parts)]
        del parts
        torch.cuda.empty_cache()
        tag = (f"row 13 {tuple(buf.shape)}, {int(counts.sum())} live rows "
               f"(overlap {plan.overlap}; weight sets by packed tiles "
               f"{cs._tiles_by_set(torch, counts.sum(1))})")
        errs = [cs._bwd_close(torch, fn(), want, fn(), tol, f"{tag} {who}")
                for who, fn in (("this", new), ("other", old))]
        del want
        torch.cuda.empty_cache()
        print(f"{tag}: relative err this {errs[0]:.3g}, other "
              f"{errs[1]:.3g}; this version's scratch and staging "
              f"{k.fused_dispatch_bwd_kernel.transient_bytes / 1e9:.3f} GB",
              flush=True)
        dn, do = turns(tag, new, old, cs.MOE_BWD_KERNELS, reps=2)
        for who, text, marks, fn in (
                ("this", (_build.CSRC / "moe_dispatch_bwd.cu").read_text(),
                 "packed", None),
                ("other", texts["moe_dispatch_bwd"], "padded", old)):
            try:
                lib = build(torch, cs, _build, "moe_dispatch_bwd",
                            stamp(text, '#include "expert_bwd.cuh"\n',
                                  ROW13_MARKS[marks]),
                            _build.CSRC if who == "this" else other_dir,
                            f"{who}_row13_split")
            except ValueError as e:
                print(f"  {who} row 13 split: not taken ({e})")
                continue
            if who == "this":
                saved = _build.library("moe_dispatch_bwd")
                _build._loaded["moe_dispatch_bwd"] = lib
                try:
                    shares = _row13_split(torch, cs, lib, new)
                finally:
                    _build._loaded["moe_dispatch_bwd"] = saved
            else:
                shares = _row13_split(
                    torch, cs, lib, _other_row13(torch, lib, buf, ws, counts,
                                                 dfull, group, plan))
            print(f"  {who} row 13 by pass (clock64 shares of device "
                  f"{cs._ms(dn if who == 'this' else do, 3)} ms): {shares}",
                  flush=True)


PROFILER_VARIANTS = ("no large trace", "right after", "after 3 s",
                     "after gc.collect()", "TEARDOWN_CUPTI=0",
                     "right after, autograd", "lead-in, autograd",
                     "after unprofiled launches",
                     "drained after unprofiled launches")


def profiler_variant(torch, name: str) -> None:
    """One variant of ``--profiler``, in this process: per short trace the
    GEMMs and spin kernels it holds, and (µs) the first GEMM's start on the
    card after the first ``aten::mm``'s on the host."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.randn(4096, 4096, device="cuda")
    small = torch.zeros(1024, device="cuda")
    w = torch.randn(256, 256, device="cuda", requires_grad=True)
    torch.mm(x, x)
    torch.cuda.synchronize()
    kernels = 0
    if "unprofiled" in name:  # launches with no profiler running
        for _ in range(30_000):
            small.add_(1.0)
        torch.cuda.synchronize()
        if name.startswith("drained"):  # one empty trace first
            with profile(activities=acts):
                torch.cuda.synchronize()
    elif name != "no large trace":
        with profile(activities=acts) as prof:
            if "autograd" in name:  # backward passes run on autograd's thread
                for _ in range(1_500):
                    (torch.tanh(small[:256] @ w) ** 2).sum().backward()
            else:
                for _ in range(30_000):
                    small.add_(1.0)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if "CUDA" in str(e.device_type))
        del prof
        if name == "after 3 s":
            time.sleep(3.0)
        if name == "after gc.collect()":
            gc.collect()
    seen = []
    for _ in range(30):
        with profile(activities=acts) as prof:
            if name.startswith("lead-in"):  # 20 ms on the card, then calls
                torch.cuda._sleep(40_000_000)
            for _ in range(10):
                torch.mm(x, x)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            if name.startswith("lead-in"):
                time.sleep(0.02)
        ev = prof.events()
        dev = [e for e in ev if "CUDA" in str(e.device_type)]
        gemm = sorted(e.time_range.start for e in dev
                      if "spin_kernel" not in e.name)
        mm = sorted(e.time_range.start for e in ev if e.name == "aten::mm")
        lead = round(gemm[0] - mm[0]) if gemm and mm else None
        seen.append((len(gemm), sum("spin_kernel" in e.name for e in dev),
                     lead, sum("LaunchKernel" in e.name for e in ev
                               if e not in dev)))
    print(f"profiler, {name} (large trace: {kernels} device launches): "
          f"{sum(s[0] == 0 for s in seen)} of 30 traces hold no GEMM; "
          f"GEMMs a trace {[s[0] for s in seen]}; spin kernels "
          f"{[s[1] for s in seen]}; first GEMM after first aten::mm (µs) "
          f"{[s[2] for s in seen]}; launches the host recorded "
          f"{[s[3] for s in seen]}")


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a csrc directory of another version")
    parser.add_argument("--scan-bwd", action="store_true",
                        help="only row 11 against --against's")
    parser.add_argument("--expert-bwd", action="store_true",
                        help="only rows 12 and 13 against --against's")
    parser.add_argument("--profiler", action="store_true",
                        help="only the empty-trace variants")
    parser.add_argument("--profiler-variant", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_split: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if args.profiler_variant is not None:
        profiler_variant(torch, args.profiler_variant)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    if args.profiler:
        for name in PROFILER_VARIANTS:
            env = dict(os.environ)
            if name == "TEARDOWN_CUPTI=0":
                env["TEARDOWN_CUPTI"] = "0"
            res = subprocess.run([sys.executable, __file__,
                                  "--profiler-variant", name], env=env)
            if res.returncode:
                return res.returncode
        return 0
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.plan import SCAN_CHUNK, SCAN_ROUTES
    k = cs.load_port()
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.scan_bwd:
        if args.against is None:
            parser.error("--scan-bwd needs --against")
        scan_bwd_turns(torch, cs, _build, k, g, args.against.resolve())
        return 0
    if args.expert_bwd:
        if args.against is None:
            parser.error("--expert-bwd needs --against")
        expert_bwd_turns(torch, cs, _build, k, g, args.against.resolve())
        return 0
    csrc = _build.CSRC
    now = build(torch, cs, _build, "linear_scan",
                stamped((csrc / "linear_scan.cu").read_text(), SPLIT_NOW[1]),
                csrc, "split")
    shapes = ((math.exp(-1.0), True), (0.5, False))
    for decay, pre in shapes:
        ops = scan_inputs(torch, g, 256, 2000, decay, False)
        want = k.linear_scan_plain(*ops, readout_pre=pre)
        for chunk in (16, 32, 64):
            call = scan_call(torch, now, ops, pre, chunk,
                             SCAN_ROUTES.index("prefill"))
            err = cs._scan_err(torch, call(), want)
            print(f"scan prefill, decay {decay:.3g}, pre {pre}, chunk "
                  f"{chunk} (relative err {err:.3g}): "
                  f"{split(torch, cs, now, call, SPLIT_NOW[0])}")
        del ops, want
    stream = torch.cuda.current_stream().cuda_stream
    uext = torch.randn((1032,) * 3, generator=g, device="cuda")
    prev = torch.randn((1024,) * 3, generator=g, device="cuda")
    out = torch.empty_like(prev)
    for bz in (16, 24, 32):
        def leap_bz(bz=bz):
            st = _build.library("wave_step").repro_leap(
                uext.data_ptr(), 0, *uext.stride()[:2], prev.data_ptr(), 0,
                *prev.stride()[:2], None, 0, 0, 0, 0.1, out.data_ptr(), 0,
                *out.stride()[:2], 1, 1024, 1024, 1024, bz, 1.0, 1, stream)
            if st != 0:
                raise RuntimeError(f"leap launch failed: {st}")
        print(f"leap tma at 1024^3, bz {bz}: "
              f"{cs.cuda_ms(torch, leap_bz, 5):.4f} ms, device "
              f"{cs._ms(cs.device_ms(torch, leap_bz, 5, cs.LEAP_KERNELS), 4)}")
    # event times a call of leap right after its plain version's frees,
    # with empty_cache() (as chip_smoke.py before each timing) and without
    def per_call(fn, n=8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        ev[0].record()
        for i in range(n):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        return " ".join(f"{ev[i].elapsed_time(ev[i + 1]):.3f}"
                        for i in range(n))

    for freed in (True, False, True):
        k.leap_plain(uext, prev, 0.1)
        torch.cuda.synchronize()
        if freed:
            torch.cuda.empty_cache()
        print(f"leap at 1024^3 after its plain version"
              f"{' and empty_cache()' if freed else ''}, ms a call: "
              f"{per_call(lambda: k.leap(uext, prev, 0.1))}")
    del uext, prev, out
    torch.cuda.empty_cache()
    if args.against is None:
        return 0

    other_dir = args.against.resolve()
    texts = {n: (other_dir / f"{n}.cu").read_text()
             for n in ("wave_step", "fused_wave_step", "linear_scan")}
    other = {n: build(torch, cs, _build, n, t, other_dir, f"other_{n}")
             for n, t in texts.items()}
    names = cs.LEAP_KERNELS + cs.SCAN_KERNELS + cs.FUSED_KERNELS

    def turns(label, new, old, reps):
        t = [cs.cuda_ms(torch, old, reps), cs.cuda_ms(torch, new, reps),
             cs.cuda_ms(torch, new, reps), cs.cuda_ms(torch, old, reps)]
        dn = cs.device_ms(torch, new, reps, names)
        do = cs.device_ms(torch, old, reps, ("leap_kernel",
                                             "linear_scan_kernel")
                          + names)
        print(f"{label}: this {t[1]:.4f} / {t[2]:.4f} ms (device "
              f"{cs._ms(dn, 4)}), other {t[0]:.4f} / {t[3]:.4f} ms (device "
              f"{cs._ms(do, 4)})")

    for lead, zl in ((1, 1024), (4, 256)):
        u = torch.randn(lead, zl, 1024, 1024, generator=g, device="cuda")
        uext = torch.nn.functional.pad(u, (4,) * 6)
        del u
        prev = torch.randn(lead, zl, 1024, 1024, generator=g, device="cuda")
        want = k.leap_plain(uext, prev, 0.1)
        lim = 2e-5 * float(want.abs().max())
        out = torch.empty_like(prev)
        o_args = [uext.data_ptr(), *uext.stride()[:3], prev.data_ptr(),
                  *prev.stride()[:3], None, 0, 0, 0, 0.1, out.data_ptr(),
                  *out.stride()[:3], lead, zl, 1024, 1024, 32, 1.0]
        routed = "int route" in texts["wave_step"]

        def old_leap():
            st = other["wave_step"].repro_leap(
                *o_args, *((1,) if routed else ()), stream)
            if st != 0:
                raise RuntimeError(f"other leap launch failed: {st}")

        old_leap()
        cs.check(cs.max_err(torch, out, want) <= lim, "other leap")
        if not routed:
            try:
                lib = build(torch, cs, _build, "wave_step",
                            stamped(texts["wave_step"], SPLIT_EARLIER_LEAP[1]),
                            other_dir, "other_leap_split")

                def split_leap():
                    st = lib.repro_leap(*o_args, stream)
                    if st != 0:
                        raise RuntimeError(f"leap launch failed: {st}")
                shares = split(torch, cs, lib, split_leap,
                               SPLIT_EARLIER_LEAP[0])
                print(f"  other leap's split: {shares}")
            except ValueError as e:
                print(f"  other leap's split: not taken ({e})")
        cs.check(cs.max_err(torch, k.leap(uext, prev, 0.1), want) <= lim,
                 "leap")
        del want
        turns(f"leap ({lead}, {zl}, 1024, 1024) through a padded grid",
              lambda: k.leap(uext, prev, 0.1), old_leap, 5)
        del uext, prev, out
        torch.cuda.empty_cache()

    fused_step(torch, cs, k, g, other["fused_wave_step"],
               "repro_fused_wave_step_carried" in texts["fused_wave_step"],
               turns)

    routed = "int route" in texts["linear_scan"]
    for (decay, pre), T in ((shapes[0], 2000), (shapes[1], 2000),
                            (shapes[0], 1)):
        ops = scan_inputs(torch, g, 256, T, decay, T == 1)
        want = k.linear_scan_plain(*ops, readout_pre=pre)
        old = scan_call(torch, other["linear_scan"], ops, pre, 64,
                        (SCAN_ROUTES.index("decode" if T == 1 else "prefill")
                         if routed else None))
        err_old = cs._scan_err(torch, old(), want)
        new = lambda: k.linear_scan_kernel(*ops, readout_pre=pre)  # noqa
        err_new = cs._scan_err(torch, new(), want)
        cs.check(max(err_old, err_new) <= 2e-4, "scan against plain")
        turns(f"scan T {T}, decay {decay:.3g}, pre {pre} (this: chunk "
              f"{SCAN_CHUNK}, other: chunk 64; relative err {err_new:.3g} "
              f"/ {err_old:.3g})", new, old, 5 if T > 1 else 50)
        if T > 1 and not routed:
            try:
                lib = build(torch, cs, _build, "linear_scan",
                            stamped(texts["linear_scan"], SPLIT_EARLIER[1]),
                            other_dir, "other_split")
                call = scan_call(torch, lib, ops, pre, 64, None)
                print(f"  other scan's split: "
                      f"{split(torch, cs, lib, call, SPLIT_EARLIER[0])}")
            except ValueError as e:
                print(f"  other scan's split: not taken ({e})")
        del ops, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
