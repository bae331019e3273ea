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
