#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a), holds every kernel against its plain PyTorch version on small
ragged shapes, then drives the port's main path at the paper's sizes:

* the ring (Cannon) all-gather matmul at N = 30240 in bf16 over 4 virtual
  ranks, fused and host-ring, each timed with CUDA events, every GEMM of
  both on the tensor-core route (TMA + wgmma; checked per route);
* Minimod at 1024³ over nz = 4, 10 steps from random fields, fused
  (carried halos) and host, each held against a single-grid oracle: every
  fused step one launch of the fused wave-step kernel's carried schedule
  and no leap, every host step one leap, all on the TMA plane ring
  (checked per mode and route), and the fused run's counters equal to the
  emulation's;
* one fused wave step (the single-step schedule) at (256, 1024, 1024) per
  rank over nz = 4;
* the serving engine on glm4-9b at full width (random weights from a seed,
  two TP ranks stacked on the card): 8 requests of 256-3000 prompt tokens,
  32 new tokens each, 4 slots, chunked prefill of 512 — every attention of
  the model runs the flash-attention kernel;
* the same engine and traffic on qwen3-moe-235b-a22b at full width with
  its depth cut to 8 layers, two EP/TP ranks (64 experts each) under
  ``dispatch_impl="fused"``: every MoE layer of every decode step and
  prefill chunk runs the fused dispatch kernel (puts, grouped expert MLP,
  returns), then one 512-token prefill chunk under the default ``"a2a"``,
  whose grouped GEMMs run the expert-MLP kernel — every launch of both on
  the tensor-core route;
* the same engine and traffic on deepseek-v3-671b at full width with its
  depth cut to its 3 leading dense layers and 2 MoE layers (MLA, the
  latent cache, one shared and 128 routed experts a rank) under
  ``dispatch_impl="fused"``: every chunk's attention runs flash at D =
  192, Dv = 128, G = 1 on the tensor-core route, every decode step's
  attention the absorbed latent form (einsums, no kernel), every MoE layer
  the fused dispatch on the tensor cores; flash and the ring kernel at the
  MLA chunk shape beside SDPA, and chunked prefill against token-by-token
  on an f32 cut (1 dense and 1 MoE layer of 32 experts);
* qwen1.5-110b and command-r-plus-104b at full width with their depth cut
  to 4: one 512-token chunk and 8 greedy decode steps each through the
  built steps, every flash launch on the route the rule gives (G = 8: the
  tensor cores; command-r-plus's G = 12: the CUDA cores), the chunk's
  flash call timed beside SDPA;
* rwkv6-7b and zamba2-1.2b at full width and depth on the same mesh,
  through their prefill and decode steps (the serving engine takes
  positional KV caches only, as in the reference): 4 prompts of 2000
  tokens in one prefill call, then 32 greedy decode steps — every RWKV
  and Mamba2 layer's recurrence runs the linear-scan kernel (the prefill
  call's on its prefill route, every decode step's on its decode route;
  checked per route), zamba2's shared attention the flash kernel; and
  prefill-then-decode against token-by-token decode on an f32 cut of each;
* paligemma-3b at full width and depth on the same mesh under
  ``seq_parallel="ring"``, through the same engine and traffic as glm4-9b:
  every chunked-prefill attention runs the fused ring-attention kernel (the
  chunk's shared queries over each rank's S-stripe of the replicated
  cache), every decode attention the flash kernel at head_dim 256, G = 8;
  one full-width chunk call under ``"ring"`` against the same call under
  ``"allgather"``, and chunked prefill against token-by-token on an f32 cut;
  then paligemma-3b's attention block trained under ``seq_parallel="ring"``
  at full width (data 1 x model 4, 4 x 4096 tokens, bf16): one forward and
  backward of a scalar loss through the ring kernel with the rows' lse and
  its gradient kernel (``csrc/ring_attention_bwd.cu``), against the same
  block under ``"allgather"`` (flash and its gradient), and on an f32 cut
  against the plain emulation's gradient; the gradient kernel timed at
  that shape beside its bound, its plain version, flash's gradient on the
  same global problem and SDPA's backward;
* after the runtime and examples phases, training: stablelm-3b at full
  width and depth (random bf16 weights, data 2 x model 2) for 4 steps of
  8 x 1024 tokens in microbatches of 2 through the port's launcher, every
  attention's forward and recomputed forward on the flash kernel and
  every backward on its gradient kernel's tensor-core route (counted per
  route), each step's time and
  tokens/s beside its bound, the peak memory, one more step profiled by
  kernel group; then at depth 2 on pod 2 x data 2 x model 2 a step on the
  kernels against the same step on their plain versions, the flat
  backend against the hierarchical one, the int8 codec against flat, and
  a checkpoint saved at step 2 and restored, step 3 bit for bit the
  uninterrupted run's;
* the long-context decode: zamba2-1.2b at full width and depth at the
  reference's long_500k cell (B = 1, S = 524,288) on data 4 x model 2, its
  K/V caches context-sharded over "data" (131,072 rows a rank, 25.8 GB):
  a 2000-token prompt prefilled, the later rows filled from a seed, 32
  greedy decode steps from 64 rows short of S, every decode attention
  ``cp_decode_attention`` (row 5's kernel a rank with the lse, non-causal,
  merged by three OMPCCL all-reduces); the partial alone at its 131,072
  keys beside SDPA over the same keys, and the sharded decode against the
  replicated one at S = 32,768;
* the audio family: hubert-xlarge at full width and depth on data 2 x
  model 2, the encoder's forward over 8 x 1500 frames, then 4 masked-frame
  training steps of 8 x 1024 frames through the launcher under the tp
  layout and again under ``dp_only``, every attention forward and
  backward non-causal on the tensor cores at head_dim 80; at depth 2 the
  kernels' step against the plain versions' and dp_only's first loss
  against tp's;
* the recurrent families' training, on data 2 x model 2 with the same
  traffic (4 steps of 8 x 1024 tokens, microbatch 2): zamba2-1.2b at full
  width and depth through the launcher, rwkv6-7b at full width with its
  depth cut to 8 of 32 layers: every scan's forward and remat forward on
  the scan kernel, every scan's backward on its gradient kernel
  (``csrc/linear_scan_bwd.cu``), zamba2's shared attention on flash and
  its gradient on the tensor cores (counted per route), step times and
  tokens/s beside the bound, the peak memory, one more step profiled by
  kernel group; at depth 2 (zamba2: 6) each rank's loss and gradients on
  the kernels against the plain versions'; the scan's backward at a
  layer's training shape against its plain version (both readouts, a row
  of decays below 1e-38), twice for equal bits, timed;
* the weight ring of the ZeRO-3 gather (``use_ring_matmul``): at depth 2
  stablelm-3b's loss and gradients through the ring ("fused" and "host")
  against the all-gather path's, then 2 full-width steps through the
  fused ring in turns with 2 all-gather steps, their times side by side;
* training qwen3-moe-235b-a22b at full width with its depth cut to 1 of
  94 layers (Adafactor) on data 2 x model 2: 4 steps of 8 x 1024 tokens
  under the capacity all-to-all, every expert MLP's forward and remat
  forward on its kernel and every backward on its gradient kernel
  (``csrc/expert_mlp_bwd.cu``), then 2 steps under the dropless fused
  ring in microbatches of one sequence, every MoE layer on the fused
  dispatch and its gradient kernel (``csrc/moe_dispatch_bwd.cu``), every
  attention on flash and its gradient, all on the tensor cores and no
  plain version on either path (counted), with the drop counts, step
  times, tokens/s, peak memory and one profiled step; both gradient
  kernels at the steps' calls against their plain versions, twice for
  equal bits, timed; at depth 1 in f32 the kernels' loss, gradients and
  drops against the plain versions' with identical routing;

* fault injection (``repro_torch.core.faults``): each fused kernel's path
  run twice against a calm context (an inert plan) and a chaos context (a
  seeded plan of drop, fail and timeout faults at p = 0.3 a dispatch,
  retried without sleeping) — the fused and host rings at N = 30240,
  Minimod at 1024³ fused and host, the fused MoE dispatch at qwen3-moe's
  chunk shape, the ring attention at paligemma's served chunk — outputs
  bit for bit, the call, byte and RMA logs, each wrapper's launches and
  routes equal, every fault recovered by one retry; glm4-9b at full width
  and depth served undisturbed, through a graceful death of rank 0
  mid-decode (its pages drained over the validated migrate) and through
  an abrupt one (its pages lost, its requests requeued), tokens equal and
  the page ledger balanced; stablelm-3b at full width and depth 2 on data
  2 x model 2 through the launcher as a user runs it (its own retry
  policy) with and without ``--chaos-seed``, losses, gradient norms and
  parameters bit for bit, and with ``--kill-rank-step`` (the elastic
  restore onto half the ranks): every loss within ELASTIC_LOSS_TOL and
  every final parameter within ELASTIC_PARAM_TOL of the uninterrupted
  run's (the reduction order's gap, well under what a broken restore
  makes) and the final loss within the reference's 5e-2;

* rows 1-4 from several processes on the card: the ring at N = 30240 and
  Minimod at 1024³ (fused and host) at 1 x 4 in this process, then in 2
  and 4 worker processes (this script re-invoked with ``--mp-worker``,
  loading the kernels built above) joined over torch.distributed's gloo,
  a verb that crosses processes moving host copies staged through pinned
  memory: every rank's output bytes and the logical logs equal to the
  1 x 4 run's, each process's launches and routes of rows 1-4 as
  predicted (the ring across processes step by step on row 1, Minimod's
  carried step over each process's box on row 4), the 2 x 2 ring under a
  seeded chaos plan recovering every fault, each topology's times and
  the transport's latency and bandwidth beside ``LinkModel``'s; a worker
  that fails or hangs fails the run;

with every kernel's launch count (and the per-route counts of the two GEMM
and the two attention kernels, the attention gradient, the wave step and
the scan, and flash's split-combine count) zeroed
just before each path and read just after it; every flash and
ring-attention launch of a served model must take the tensor cores, and
flash at glm4-9b's and paligemma-3b's decodes must split its keys over
at least 132 blocks.  The build's
registers and spills are logged per kernel instance.  Then it times each
kernel at the main path's shapes beside its plain version and, where one
exists, the one PyTorch call that computes the same function (sampling
the card's SM clock and power draw over the fused ring's, flash's chunk
and the 4 x 4096 ring attention's timings; the attention kernels also
and the two MoE kernels by their device time from the profiler, warm
and with L2 flushed; the wave step and the scan by their warm device
time too, the wave step also at Minimod host mode's batched shape, the
fused step on both schedules, both with the host's share of their event
time),
times Minimod's two modes over repeated alternated runs, prints each
serving phase's time to first token (the recurrent phases' prefill time)
and decode step time with their bounds (and the MoE phase's plans, drop
count and routed experts), times the ring kernel at the served chunk and
at a sequence-parallel shape (4 virtual ranks of 4096 tokens), and prints
one JSON line of per-kernel numbers, the card's name and power limit, and
a last JSON line with the device.  Any failed phase exits non-zero; so
does a machine without CUDA and a directory that does not hold the port.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): bytes/s of HBM3 and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
STENCIL_OPS_PER_POINT = 41      # 1 + 12·3 (star) + 4 (leapfrog) flops
WARM_S = 0.1                    # least warm-up (s) of an event timing

# the main path's sizes
RING_N, RING_RANKS = 30240, 4
GRID, NZ, STEPS = 1024, 4, 10
MINIMOD_REPS = 5                # timed runs of each Minimod mode
# serving: glm4-9b at full width on the data 1 x model 2 smoke mesh
SERVE_ARCH, SERVE_RANKS = "glm4-9b", 2
# MoE serving: qwen3-moe-235b-a22b at full width, its 94 layers cut to 8
# (42 GB of bf16 weights), on the same mesh (EP = TP = 2)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8
# MLA serving: deepseek-v3-671b at full width, its 61 layers cut to its 3
# leading dense layers and 2 MoE layers (54.31 GB of bf16 weights, MTP
# leaves included), on the same mesh and traffic under the fused dispatch;
# its f32 cut for chunked == token by token: 1 dense and 1 MoE layer of 32
# experts, capacity factor 4.0 (tests/test_models.py's ample capacity)
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 5
MLA_CUT_EXPERTS, MLA_CUT_CF = 32, 4.0
MLA_PLAIN_EXPERTS = 8           # experts a plain expert-MLP call holds
# the dense GQA configs at full width, depth cut to 4: one 512-token chunk
# and GQA_DECODES decode steps through the built steps
GQA_ARCHS, GQA_LAYERS, GQA_DECODES = ("qwen1-5-110b",
                                      "command-r-plus-104b"), 4, 8
SLOTS, MAX_LEN, CHUNK, PAGE_TOKENS = 4, 4096, 512, 64
REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 8, 256, 3000, 32
# the recurrent families at full width and depth on the same mesh, through
# their prefill and decode steps: prompts of 2000 tokens (31 chunks of 64
# and a ragged 16), 32 greedy tokens each
REC_ARCHS = ("rwkv6-7b", "zamba2-1-2b")
REC_REQUESTS, REC_PROMPT, REC_NEW = 4, 2000, 32
REC_PREFILL_REPS = 4            # timed prefill calls after the served one
# the long-context decode: zamba2-1.2b at full width and depth on data 4 x
# model 2 at the reference's long_500k cell (B = 1, S = 524,288), the K/V
# caches context-sharded over "data" (131,072 rows a rank, 25.8 GB in all)
# and the weights replicated over "data" (fsdp_params=False): a prompt of
# REC_PROMPT tokens prefilled, the later rows filled from a seed, pos set
# LONG_TAIL rows short of S, then LONG_NEW greedy decode steps; the parity
# check at LONG_PARITY_S against the replicated cache, LONG_PARITY_NEW
# teacher-forced steps (the reference's 2e-2 relative)
LONG_ARCH, LONG_MESH, LONG_S, LONG_TAIL, LONG_NEW = (
    "zamba2-1-2b", (("data", "model"), (4, 2)), 524_288, 64, 32)
LONG_PARITY_S, LONG_PARITY_NEW = 32_768, 8
# the audio family: hubert-xlarge at full width and depth on data 2 x model
# 2: the encoder's forward over AUDIO_FWD_BATCH x AUDIO_FWD_FRAMES frames,
# then the launcher's TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ frames
# (microbatch TRAIN_MICRO) under each layout; its checks at depth 2
AUDIO_ARCH, AUDIO_FWD_BATCH, AUDIO_FWD_FRAMES = "hubert-xlarge", 8, 1500
AUDIO_LAYOUTS = ("tp", "dp_only")
# sequence-parallel serving: paligemma-3b at full width and depth under
# seq_parallel="ring" on the same mesh, engine and traffic as glm4-9b; the
# ring kernel also timed at a training-layout shape: 4 virtual ranks of
# 4096 tokens (q_sharded, causal)
RING_ARCH, RING_CHUNK_AT = "paligemma-3b", 2048
SEQ_RANKS, SEQ_T_LOC = 4, 4096
# the unified runtime: glm4-9b's full parameter tree registered on the
# 8-rank smoke mesh (pod 2 x data 2 x model 2), a gradient of its embedding
# table's shape all-reduced over DP = (pod, data) through the flat and the
# hierarchical backend, and the host time of one all-reduce call of a
# 4 KiB payload (LinkModel.dispatch_s) in DISPATCH_TIMINGS timings of
# DISPATCH_REPS calls; the least of them must lie within DISPATCH_BAND
# (relative) of LinkModel.dispatch_s.  The host's cores are shared: the
# runs' medians have ranged from 50.90 to 117.03 us and single timings up
# to 137.03, while the least of a run's nine has stayed between 45.78 and
# 81.51 us where recorded
RT_ARCH, RT_RANKS, DISPATCH_BYTES = "glm4-9b", 8, 4096
DISPATCH_REPS, DISPATCH_TIMINGS, DISPATCH_BAND = 200, 9, 0.5
# bf16's unit roundoff: the flat sum rounds once, the hierarchical one's
# phases round three times, so the two agree within 4u of the largest value
BF16_U = 2.0 ** -8
# the paper's examples: Cannon at Fig. 7's N (f32, 8 ranks: stripes of
# 3780), Minimod at Fig. 8's 1024^3 over nz = 4, 10 steps, in four runs
# (run_minimod's arguments), each also run on random fields against the
# single-grid oracle, and at a 64^3 grid on the card and on the CPU
CANNON_N, CANNON_RANKS = 30240, 8
MINIMOD_RUNS = (("none", {"mode": "none"}),
                ("fused", {"mode": "fused"}),
                ("fused asymmetric", {"mode": "fused",
                                      "weights": (3, 2, 2, 1)}),
                ("fused 2-D", {"mode": "fused", "nz": 2, "ny": 2}))
PARITY_GRID = 64


# the matmul kernel's device functions, both routes
MATMUL_KERNELS = ("matmul_kernel", "matmul_tc_kernel")
# the flash kernel's device functions, both routes and the split combine
FLASH_KERNELS = ("flash_fwd_kernel", "flash_tc_kernel", "flash_combine_kernel")
# the fused MoE dispatch's and the expert MLP's, both routes
MOE_KERNELS = ("dispatch_kernel", "dispatch_tc_kernel")
EXPERT_KERNELS = ("gate_up_kernel", "down_kernel", "gate_up_tc_kernel",
                  "down_tc_kernel", "ex_list_kernel")
# the expert MLP's gradient (row 12) and the fused dispatch's (row 13)
EXPERT_BWD_KERNELS = ("exb_simt_kernel", "exb_list_kernel",
                      "exb_pack_kernel", "exb_rows_tc_kernel",
                      "exb_dx_tc_kernel", "exb_dw_tc_kernel")
MOE_BWD_KERNELS = ("dispatch_bwd_kernel", "dispatch_bwd_tc_kernel")
# the wave step's, both routes; the linear scan's, both routes
LEAP_KERNELS = ("leap_tma_kernel", "leap_kernel")
FUSED_KERNELS = ("fused_tma_kernel", "fused_step_kernel",
                 "fused_carried_kernel")
SCAN_KERNELS = ("scan_prefill_kernel", "scan_decode_kernel")
SCAN_BWD_KERNELS = ("scan_bwd_kernel",)


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
    """Device time of ``fn`` in ms, from CUDA events over ``reps`` calls,
    after ``warmup`` calls and, if any, at least ``WARM_S`` seconds of
    calls: after ``torch.cuda.empty_cache()`` hands memory back to CUDA,
    the next calls that allocate it again run up to a fifth slower for a
    few calls (longer after tens of GB)."""
    t0 = time.perf_counter()
    n = 0
    while n < warmup or (warmup and time.perf_counter() - t0 < WARM_S):
        fn()
        torch.cuda.synchronize()
        n += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DEVICE_TRIES = 50   # traces device_ms takes before it gives up


def device_ms(torch, fn, reps: int, names, cold_l2: bool = False):
    """Device time (ms a call) of the kernels whose names contain one of
    ``names``, from ``torch.profiler`` over ``reps`` calls of ``fn``: what
    the card spends in them, without the host's time between launches.
    ``cold_l2`` overwrites a 128 MB buffer before each call, so the call
    finds its operands in device memory, not in the 50 MB L2.  Inside each
    trace 20 ms of ``torch.cuda._sleep`` on the card lead the calls and a
    wait of 20 ms on the host follows them: right after a large trace, a
    trace without them loses the launches of its first milliseconds
    (``chip_split.py --profiler``).  Now and then, and most often late in
    a long run, a whole trace still comes back without its launches, or
    with a few of them, so a trace counts only if it holds at least ``reps
    - 1`` launches of the named kernels; else it is taken again, up to
    ``DEVICE_TRIES`` times, and the result is None if none counts.  Each
    kernel's time is its mean over the launches the trace holds, times its
    launches a call.  ``spin_kernel`` (``torch.cuda._sleep``'s) is never
    counted, even where ``names`` is ``("",)``."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(1 << 27, dtype=torch.uint8, device="cuda") \
        if cold_l2 else None
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(40_000_000)
            for _ in range(reps):
                if flush is not None:
                    flush.fill_(1)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = [e for e in prof.key_averages() if e.count > 0]
        on_card = [e for e in events
                   if "CUDA" in str(getattr(e, "device_type", "CUDA"))]
        hits = [e for e in on_card if any(n in e.key for n in names)
                and "spin_kernel" not in e.key]
        if sum(e.count for e in hits) >= max(1, reps - 1):
            us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     / e.count * max(1, round(e.count / reps))
                     for e in hits)
            return us / 1e3
        host = sum(e.count for e in events
                   if "LaunchKernel" in e.key and e not in on_card)
        log(f"device_ms: {sum(e.count for e in hits)} launches of {names} "
            f"in the trace after {reps} calls ({sum(e.count for e in on_card)}"
            f" on the card in all, {host} launch calls on the host); taken "
            f"again")
    return None


def host_and_events(torch, fn, reps: int) -> dict:
    """The host's share of a wrapper's CUDA-event time (ms a call): its time
    to enqueue one call (no synchronisation between calls), beside the
    event time over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return {"host_ms": host, "event_ms": cuda_ms(torch, fn, reps)}


def _ms(x, digits: int) -> str:
    """A device time for the log: ``digits`` decimals, or "not measured"
    where the profiler's traces held no launch of the kernel."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def sampled_ms(torch, fn, ms_each: float, what: str) -> float:
    """CUDA-event time (ms a call) of ``fn`` over about one second of
    back-to-back calls, the card's SM clock and power sampled meanwhile."""
    reps = max(10, int(1000.0 / max(ms_each, 1e-3)))
    with CardSampler() as sampled:
        ms = cuda_ms(torch, fn, reps)
    log(f"card under {what} ({reps} calls, {ms:.4f} ms each): "
        f"{sampled.summary()}")
    return ms


def ptxas_summary(text: str):
    """(kernel instance, registers, spill line) of each entry function in
    an ``nvcc -Xptxas -v`` log."""
    import re
    func, spills = None, ""
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            func = m.group(1)
        elif "spill" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            yield func, int(m.group(1)), spills
            func, spills = None, ""


class CardSampler:
    """The card's SM clock (MHz) and power draw (W) while the ``with``
    block runs, streamed by one ``nvidia-smi -lms 50`` process."""

    def __init__(self):
        import threading
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)

    def _read(self):
        for line in self._proc.stdout:
            try:
                clock, power = line.split(",")
                self.samples.append((float(clock), float(power)))
            except ValueError:
                pass

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        self._proc.wait(timeout=30)
        self._thread.join(timeout=30)

    def summary(self) -> str:
        if not self.samples:
            return "no samples"
        clocks = [c for c, _ in self.samples]
        power = [p for _, p in self.samples]
        return (f"{len(self.samples)} samples: SM clock min {min(clocks):.0f}"
                f", median {statistics.median(clocks):.0f}, max "
                f"{max(clocks):.0f} MHz; power median "
                f"{statistics.median(power):.1f}, max {max(power):.1f} W")


def max_err(torch, got, want) -> float:
    """The largest absolute difference, in f32; a tensor of more than 2^27
    elements slice by slice along its first dim (the f32 copies of a
    training call's dW would take tens of GB at once)."""
    if got.numel() > 1 << 27 and got.dim() > 1 and got.shape == want.shape:
        return max(max_err(torch, a, b)
                   for a, b in zip(got.unbind(0), want.unbind(0)))
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
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_dispatch import fused as moe_fused
    from repro_torch.kernels.moe_dispatch import kernel as moe_kernel
    from repro_torch.kernels.linear_scan import kernel as ls
    from repro_torch.kernels.ring_attention import fused as ra_fused
    from repro_torch.kernels.ring_attention.ref import ring_attention_ref
    return SimpleNamespace(
        fused_ring_attention_kernel=ra_fused.fused_ring_attention_kernel,
        fused_ring_attention_plain=ra_fused.fused_ring_attention_interpret,
        fused_ring_attention_bwd_kernel=(
            ra_fused.fused_ring_attention_bwd_kernel),
        fused_ring_attention_bwd_plain=ra_fused.fused_ring_attention_bwd_plain,
        ring_attention_ref=ring_attention_ref,
        linear_scan_kernel=ls.linear_scan_kernel,
        linear_scan_plain=ls.linear_scan_plain,
        linear_scan_bwd_kernel=ls.linear_scan_bwd_kernel,
        linear_scan_bwd_plain=ls.linear_scan_bwd_plain_dla,
        scan_bwd_smem_bytes=ls.scan_bwd_smem_bytes,
        BWD_BLOCKS_PER_SM=ls.BWD_BLOCKS_PER_SM,
        flash_attention_kernel=fa.flash_attention_kernel,
        flash_attention_plain=fa.flash_attention_plain,
        flash_attention_bwd_kernel=fa.flash_attention_bwd_kernel,
        flash_attention_bwd_plain=fa.flash_attention_bwd_plain,
        flash_combine_kernel=fa.flash_combine_kernel,
        flash_combine_plain=fa.flash_combine_plain,
        expert_mlp=moe_kernel.expert_mlp,
        expert_mlp_plain=moe_kernel.expert_mlp_plain,
        expert_mlp_bwd=moe_kernel.expert_mlp_bwd,
        expert_mlp_bwd_plain=moe_kernel.expert_mlp_bwd_plain,
        fused_dispatch_bwd_kernel=moe_fused.fused_dispatch_bwd_kernel,
        fused_dispatch_bwd_plain=moe_fused.fused_dispatch_bwd_plain,
        fused_moe_dispatch_kernel=moe_fused.fused_moe_dispatch_kernel,
        fused_moe_dispatch_plain=moe_fused.fused_moe_dispatch_plain,
        fused_moe_dispatch_interpret=moe_fused.fused_moe_dispatch_interpret,
        matmul_kernel=matmul_kernel, matmul_ref=matmul_ref,
        fused_ring_allgather_matmul_kernel=(
            ring_fused.fused_ring_allgather_matmul_kernel),
        ring_allgather_matmul_plain=ring_allgather_matmul_plain,
        leap=leap, leap_plain=leap_plain,
        fused_wave_step_kernel=st_fused.fused_wave_step_kernel,
        fused_step_plain=st_fused.fused_wave_step_plain,
        fused_step_carried_plain=st_fused.fused_wave_step_carried_plain,
        Halos=st_fused.Halos)


# -- every kernel against its plain version on small, ragged shapes ----------
# Tolerances, relative to the result's largest magnitude: f32 1e-5 (GEMM) /
# 2e-5 (stencil), f32 sums in another order with fused multiply-adds; f16
# 2e-3 and bf16 1.6e-2, one ulp of the output type (2^-10 / 2^-7 relative)
# plus the accumulation order.  Each check also holds the wrapper to one
# launch count per call.  tests/test_torch_cuda.py runs the same checks.


def _counted(wrapper, fn, route=None):
    """``fn()``, checking that ``wrapper`` counted exactly one launch (on
    ``route``, where one is given)."""
    before = wrapper.launches
    routes = dict(getattr(wrapper, "route_launches", {}))
    got = fn()
    check(wrapper.launches == before + 1,
          f"{wrapper.__name__}: {wrapper.launches - before} launches counted")
    if route is not None:
        taken = [r for r, c in wrapper.route_launches.items()
                 if c != routes[r]]
        check(taken == [route] and wrapper.route_launches[route]
              == routes[route] + 1,
              f"{wrapper.__name__}: took {taken}, not the {route} route")
    return got


def _zero_counts(wrappers) -> None:
    """Every wrapper's launch count, per-route counts and the flash
    combine's count to 0, just before a path is driven."""
    for wrapper in wrappers.values():
        wrapper.launches = 0
        for route in getattr(wrapper, "route_launches", {}):
            wrapper.route_launches[route] = 0
        if hasattr(wrapper, "combine_launches"):
            wrapper.combine_launches = 0


def _attention_routes(wrappers, tag: str) -> dict:
    """The attention kernels' per-route counts of the path just driven;
    fails unless every one of their launches took the tensor cores."""
    routes = {name: dict(wrappers[name].route_launches)
              for name in ("flash_attention", "fused_ring_attention")}
    for name, taken in routes.items():
        check(taken["simt"] == 0
              and taken["wgmma"] == wrappers[name].launches,
              f"{tag}: a {name} launch left the tensor cores: {taken}")
    log(f"{tag}: attention routes {routes}, flash combine launches "
        f"{wrappers['flash_attention'].combine_launches}")
    return routes


def check_matmul(torch, k, g) -> None:
    """Ragged edges, every dtype, both routes: the 16-bit cases whose K
    and N are multiples of 8 run on the tensor cores (with ragged M and N
    edges and a K that is not a multiple of the tile's), the rest on the
    CUDA cores (M, N and K off the 128 x 128 x 16 tile, K under one step,
    several tiles and steps, 16-bit operands off the tensor cores' rule)."""
    s, tc = "simt", "wgmma"
    for (M, K, N, dt, tol, route) in [
            (33, 65, 17, torch.float32, 1e-5, s),
            (130, 7, 260, torch.float32, 1e-5, s),
            (257, 1000, 129, torch.float32, 1e-5, s),
            (1, 300, 5, torch.float32, 1e-5, s),
            (131, 13, 77, torch.bfloat16, 1.6e-2, s),
            (100, 130, 70, torch.float16, 2e-3, s),
            (64, 96, 48, torch.bfloat16, 1.6e-2, tc),
            (256, 512, 256, torch.float32, 1e-5, s),
            (200, 264, 136, torch.bfloat16, 1.6e-2, tc),
            (200, 264, 136, torch.float16, 2e-3, tc),
            (300, 1000, 392, torch.bfloat16, 1.6e-2, tc),
            (130, 72, 264, torch.float16, 2e-3, tc)]:
        x = torch.randn(M, K, generator=g, device="cuda").to(dt)
        w = torch.randn(K, N, generator=g, device="cuda").to(dt)
        want = k.matmul_ref(x, w)
        err = max_err(torch, _counted(k.matmul_kernel,
                                      lambda: k.matmul_kernel(x, w), route),
                      want)
        check(err <= tol * float(want.float().abs().max()),
              f"matmul {M}x{K}x{N} {dt}: err {err}")


def check_ring(torch, k, g) -> None:
    """n = 1..5 ranks, both directions and bidi: f32 and bf16 at a ragged
    shape on the CUDA cores (f32 also over several tiles), and bf16 at an
    aligned one (K and n_loc multiples of 8, t_loc and n_loc ragged against
    the tile) on the tensor cores."""
    from repro_torch.kernels.plan import RingPlan
    kern = k.fused_ring_allgather_matmul_kernel
    cases = ((torch.float32, 1e-5, (5, 33, 7), "simt"),
             (torch.float32, 1e-5, (130, 40, 200), "simt"),
             (torch.bfloat16, 1.6e-2, (5, 33, 7), "simt"),
             (torch.bfloat16, 1.6e-2, (200, 264, 136), "wgmma"))
    for n in range(1, 6):
        for dt, tol, (t_loc, K, n_loc), route in cases:
            for direction in ("bidi", "cw", "ccw"):
                x = torch.randn(n, t_loc, K, generator=g,
                                device="cuda").to(dt)
                w = torch.randn(n, K, n_loc, generator=g,
                                device="cuda").to(dt)
                plan = RingPlan(n=n, direction=direction,
                                slots=1 if n == 1 else 2)
                want = k.ring_allgather_matmul_plain(x, w)
                got = _counted(kern, lambda: kern(x, w, plan=plan), route)
                err = max_err(torch, got, want)
                check(err <= tol * float(want.float().abs().max()),
                      f"ring n={n} {dt} {direction} {route}: err {err}")


def _leap_route(X, *tensors) -> str:
    """The route a leap case must take: the TMA ring for X a multiple of 4
    and every operand's pointer and batch / z / y strides 16-byte aligned
    (f32), the CUDA-core tile otherwise (plan.stencil_route's rule,
    restated here so the checks hold it)."""
    ok = X % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(4 * s % 16 == 0
                                       for s in t.stride()[-4:-1])
        for t in tensors)
    return "tma" if ok else "simt"


def check_leap(torch, k, g) -> None:
    """Both routes: aligned shapes on the TMA ring (ragged tiles in X, Y
    and Z, several tiles each way, slices of larger tensors), X off the
    rule (70) and a pointer off 16 bytes on the CUDA cores; scalar and
    per-point c2; a launch forced onto the TMA route off its rule is
    refused."""
    from repro_torch.kernels.stencil import kernel as st_mod
    R = 4

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    for (Z, Y, X) in [(17, 12, 20), (9, 33, 70), (40, 8, 8), (20, 70, 136),
                      (70, 32, 64)]:
        uext, prev = rnd(2, Z + 2 * R, Y + 2 * R, X + 2 * R), rnd(2, Z, Y, X)
        c2 = torch.rand(2, Z, Y, X, generator=g, device="cuda") * 0.2
        for c in (0.1, c2):
            ops = (uext, prev) + ((c,) if isinstance(c, torch.Tensor) else ())
            want = k.leap_plain(uext, prev, c, dx=1.5)
            got = _counted(k.leap, lambda: k.leap(uext, prev, c, dx=1.5),
                           _leap_route(X, *ops))
            err = max_err(torch, got, want)
            check(err <= 2e-5 * float(want.abs().max()),
                  f"leap {Z}x{Y}x{X}: err {err}")
        big = rnd(2, Z + 4 * R, Y + 2 * R, X + 2 * R)   # a slice view
        out = torch.zeros(2, Z + 2 * R, Y, X, device="cuda")
        view = big[:, R:Z + 3 * R]
        _counted(k.leap, lambda: k.leap(view, prev, 0.1, out=out[:, R:Z + R]),
                 _leap_route(X, view, prev, out[:, R:Z + R]))
        want = k.leap_plain(view, prev, 0.1)
        check(max_err(torch, out[:, R:Z + R], want)
              <= 2e-5 * float(want.abs().max()), "leap on views")
    # prev one element off its allocation: the CUDA cores
    Z, Y, X = 12, 40, 64
    uext = rnd(1, Z + 2 * R, Y + 2 * R, X + 2 * R)
    prev = rnd(Z * Y * X + 1)[1:].view(1, Z, Y, X)
    want = k.leap_plain(uext, prev, 0.1)
    got = _counted(k.leap, lambda: k.leap(uext, prev, 0.1), "simt")
    check(max_err(torch, got, want) <= 2e-5 * float(want.abs().max()),
          "leap off 16 bytes")
    _refused_off_rule(st_mod, k.leap, lambda: k.leap(uext, prev, 0.1),
                      "leap", rule_name="stencil_route", route="tma")


def check_fused_step(torch, k, g) -> None:
    """Both schedules on both routes: the single step with overlap, without
    an interior (Z = 2R) and on one rank; the carried step from random
    halos (edge ranks' included) and chained once more from the halos it
    returned; X a multiple of 4 (several tiles and Z chunks, ragged in
    each) on the TMA ring, X off the rule on the CUDA cores; scalar and
    per-point c2.  A launch forced onto the TMA route off its rule is
    refused on both schedules, and a carried launch at Z = 2R on both
    routes."""
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.kernels.stencil import fused as st_mod
    kern, R = k.fused_wave_step_kernel, 4

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def held(got, want, what):
        err = max_err(torch, got, want)
        check(err <= 2e-5 * float(want.abs().max()), f"{what}: err {err}")

    for (nz, Z, Y, X) in [(4, 12, 10, 9), (4, 8, 10, 9), (1, 12, 6, 40),
                          (3, 20, 33, 35), (4, 12, 10, 12), (4, 8, 10, 12),
                          (3, 40, 70, 136), (2, 70, 33, 64),
                          (4, 100, 40, 64)]:
        plan = OverlapPlanner().plan_halo_slots(Z, Y, X, torch.float32, nz)
        u, up = rnd(nz, 1, Z, Y, X), rnd(nz, 1, Z, Y, X)
        c2 = torch.rand(nz, 1, Z, Y, X, generator=g, device="cuda") * 0.2
        route = _leap_route(X, u)
        for c in (0.1, c2):
            tag = f"fused step nz={nz} {Z}x{Y}x{X} {route}"
            held(_counted(kern, lambda: kern(u, up, c, plan=plan), route),
                 k.fused_step_plain(u, up, c, dx=1.0), tag)
            if not (plan.overlap and nz > 1):
                continue
            h = k.Halos(rnd(nz, 1, R, Y, X), rnd(nz, 1, R, Y, X))
            a, b = u, up
            for step in (1, 2):       # chained: the halos it returned
                got, got_h = _counted(kern, lambda: kern(
                    a, b, c, plan=plan, halos=h, return_halos=True), route)
                want, want_h = k.fused_step_carried_plain(a, b, c, h, dx=1.0)
                for x, y, part in ((got, want, "out"),
                                   (got_h.z_lo, want_h.z_lo, "z_lo"),
                                   (got_h.z_hi, want_h.z_hi, "z_hi")):
                    held(x, y, f"{tag} carried step {step} {part}")
                a, b, h = got, a, got_h
    nz, Z, Y, X = 4, 12, 10, 9
    plan = OverlapPlanner().plan_halo_slots(Z, Y, X, torch.float32, nz)
    u, up = rnd(nz, 1, Z, Y, X), rnd(nz, 1, Z, Y, X)
    h = k.Halos(rnd(nz, 1, R, Y, X), rnd(nz, 1, R, Y, X))
    _refused_off_rule(st_mod, kern, lambda: kern(u, up, 0.1, plan=plan),
                      "fused step", rule_name="stencil_route", route="tma")
    _refused_off_rule(st_mod, kern, lambda: kern(u, up, 0.1, plan=plan,
                                                 halos=h),
                      "carried fused step", rule_name="stencil_route",
                      route="tma")
    # the carried entry refuses a shard with no interior (Z = 2R), which a
    # plan made for another Z could hand it, on both routes
    from repro_torch.kernels import _build
    from repro_torch.kernels.plan import STENCIL_ROUTES
    u, up, out = (rnd(nz, 1, 2 * R, Y, 12) for _ in range(3))
    lo, hi, new_lo, new_hi = (rnd(nz, 1, R, Y, 12) for _ in range(4))
    for code, route in enumerate(STENCIL_ROUTES):
        st = _build.library("fused_wave_step").repro_fused_wave_step_carried(
            u.data_ptr(), up.data_ptr(), None, 0.1, out.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), new_lo.data_ptr(),
            new_hi.data_ptr(), nz, 2 * R, Y, 12, 32, 1.0, code,
            torch.cuda.current_stream().cuda_stream)
        check(st != 0, f"carried fused step at Z = 2R on {route}: a launch "
              f"with no interior was not refused")


MINIMOD_COUNTERS = ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
                    "fences", "window_bytes", "region_sizes", "alloc_counts",
                    "z_extents", "grid", "steps", "nz", "ny", "mode")


def _stencil_counts(k) -> dict:
    """The two stencil wrappers' launch and per-route counts, now."""
    return {name: (wr.launches, dict(wr.route_launches))
            for name, wr in (("wave_step", k.leap),
                             ("fused_wave_step", k.fused_wave_step_kernel))}


def _stencil_delta(before: dict, after: dict) -> dict:
    return {name: (after[name][0] - before[name][0],
                   {r: c - before[name][1][r]
                    for r, c in after[name][1].items()})
            for name in after}


def check_minimod(torch, k, g) -> None:
    """Fused-mode Minimod on the card, 4 steps over nz = 4 from random
    fields, equals a ``device="cpu"`` run: the field within 1e-5 of its
    largest magnitude (f32 in another order over four steps) and every
    counter of ``MinimodResult``; every step one carried launch of the
    fused kernel on its route (64³: the TMA ring; X = 62: the CUDA cores)
    and no leap."""
    from repro_torch.apps.minimod import run_minimod
    steps = 4
    for grid, route in (((64, 64, 64), "tma"), ((64, 64, 62), "simt")):
        u0 = torch.randn(grid, generator=g, device="cuda") * 0.1
        up0 = torch.randn(grid, generator=g, device="cuda") * 0.1
        kw = dict(grid=grid, nz=4, steps=steps, mode="fused")
        cpu = run_minimod(u0=u0.cpu(), u_prev0=up0.cpu(), device="cpu", **kw)
        before = _stencil_counts(k)
        card = run_minimod(u0=u0, u_prev0=up0, device="cuda", **kw)
        d = _stencil_delta(before, _stencil_counts(k))
        check(d["fused_wave_step"][0] == steps
              and d["fused_wave_step"][1][route] == steps
              and d["wave_step"][0] == 0,
              f"minimod {grid}: launches {d}, not {steps} fused on {route}")
        err = max_err(torch, card.field.cpu(), cpu.field)
        check(err <= 1e-5 * float(cpu.field.abs().max()),
              f"minimod {grid}: card vs cpu err {err}")
        for attr in MINIMOD_COUNTERS:
            check(getattr(card, attr) == getattr(cpu, attr),
                  f"minimod {grid}: {attr} {getattr(card, attr)} vs "
                  f"{getattr(cpu, attr)}")


def _attention_route(torch, dt, D, Dv, G) -> str:
    """The route a sweep case's aligned, contiguous operands must take:
    the tensor cores for f16/bf16 with D a multiple of 16 in [16, 256], Dv
    a multiple of 16 in [16, 128], or 256, and G dividing 64, the CUDA
    cores otherwise (plan.attention_route's rule, restated here so the
    sweep checks it)."""
    return ("wgmma" if dt in (torch.float16, torch.bfloat16)
            and 16 <= D <= 256 and D % 16 == 0
            and ((16 <= Dv <= 128 and Dv % 16 == 0) or Dv == 256)
            and 64 % G == 0 else "simt")


def _attention_bwd_route(torch, dt, D, Dv, G) -> str:
    """The route a gradient case's aligned, contiguous operands must take:
    the tensor cores for f16/bf16 with D a multiple of 16 in [16, 128] or
    192 (MLA's heads, the wide instance) and Dv a multiple of 16 in [16,
    128], or D = Dv = 256 (paligemma-3b's heads, the 256-wide instance),
    and G dividing 64, the CUDA cores otherwise
    (plan.attention_bwd_route's rule, restated here so the cases check
    it)."""
    def width_ok(x):
        return 16 <= x <= 128 and x % 16 == 0
    return ("wgmma" if dt in (torch.float16, torch.bfloat16)
            and (((width_ok(D) or D == 192) and width_ok(Dv))
                 or D == Dv == 256)
            and 64 % G == 0 else "simt")


def check_flash(torch, k, g) -> None:
    """The reference's sweep (tests/test_kernels.py:39), per-row offsets
    (decode and a chunk with a padded tail), rows that see no key, decode
    tiles at GQA 16:1 (head_dim 128) and 8:1 (head_dim 256), a G = 16
    decode whose slots see 1 key to many key splits, a prefix window across
    key tiles, several query tiles (an odd count) with and without key
    splits, a ragged Tk with NaN past ``valid_len`` and a strided layer of a stacked
    cache with NaN past ``valid_len``; head_dim 80 (stablelm-3b's, two
    64-column boxes, the second partly filled) causal, prefix-LM, at G = 8,
    with NaN past ``valid_len`` and in a split decode, and widths off 64
    with Dv != D; deepseek-v3's MLA widths (D = 192, three boxes; Dv =
    128) at G = 1 causal with per-row offsets and NaN past ``valid_len``,
    in a prefix window and in a split decode, and D = 256 with Dv = 128;
    G = 12 (command-r-plus's, off the rule); f32, f16 and bf16, each case
    on the route the rule gives it.  The plain version folds keys in
    the kernel's key tile, so both sum in the same blocks.  Then the split
    combine against its plain version (``merge_states``).  Operands of
    mixed dtypes are refused on the card."""
    tols = {torch.float32: 2e-5, torch.float16: 2e-3, torch.bfloat16: 1.6e-2}
    kern = k.flash_attention_kernel
    cases = [
        # B, Tq, Tk, H, KH, D, Dv, causal, q_offset, prefix, valid_len, nan
        (2, 16, 16, 4, 2, 64, 64, True, 0, 0, None, False),
        (1, 8, 24, 4, 1, 32, 32, True, 16, 0, None, False),
        (2, 12, 12, 6, 6, 64, 64, False, 0, 0, None, False),
        (1, 20, 20, 8, 2, 64, 64, True, 0, 5, None, False),
        (1, 1, 33, 4, 2, 64, 64, True, 32, 0, None, False),
        (1, 16, 16, 4, 2, 32, 16, True, 0, 0, None, False),
        (3, 1, 200, 16, 1, 128, 128, True, [5, 99, 199], 0, [6, 100, 200],
         False),
        (2, 1, 300, 8, 1, 256, 256, True, [100, 299], 0, [101, 300], False),
        (2, 70, 300, 8, 2, 80, 80, True, [0, 130], 0, [70, 200], False),
        (2, 5, 40, 4, 2, 64, 64, True, 0, 0, [0, 3], False),
        (1, 33, 90, 6, 3, 48, 24, True, 10, 30, [60], False),
        # a G = 16 decode: one slot sees 1 key, others span many splits
        (3, 1, 1000, 16, 1, 128, 128, True, [0, 500, 999], 0,
         [1, 501, 1000], False),
        # a prefix window across key tiles, Dv != D
        (2, 100, 150, 8, 2, 128, 64, True, 0, 70, None, False),
        # several query tiles (an odd count), with key splits
        (1, 200, 260, 4, 4, 64, 64, True, 60, 0, None, False),
        (1, 130, 1000, 1, 1, 64, 64, True, 870, 0, [1000], False),
        # ragged Tk (not a multiple of 64), NaN past valid_len
        (2, 3, 150, 8, 2, 128, 128, True, [40, 97], 0, [43, 100], True),
        (2, 20, 150, 16, 2, 128, 128, True, [100, 40], 0, [120, 60], True),
        (4, 1, 150, 8, 1, 256, 256, True, [0, 63, 64, 149], 0,
         [1, 64, 65, 150], True),
        # head_dim 80: query tiles at G = 1 (the training shape's), a
        # prefix window at G = 8, NaN past valid_len, a split decode
        (1, 130, 130, 2, 2, 80, 80, True, 0, 0, None, False),
        (1, 100, 150, 8, 1, 80, 80, True, 0, 70, None, False),
        (2, 20, 150, 8, 1, 80, 80, True, [100, 40], 0, [120, 60], True),
        (3, 1, 1000, 8, 1, 80, 80, True, [0, 500, 999], 0, [1, 501, 1000],
         False),
        # widths off 64 with Dv != D: a prefix window, and G = 8 with NaN
        (1, 100, 100, 8, 8, 80, 48, True, 0, 70, None, False),
        (2, 33, 90, 16, 2, 112, 32, True, [10, 50], 0, [60, 90], True),
        # MLA's D = 192, Dv = 128 (a chunk with offsets, NaN past
        # valid_len; a prefix window; a split decode), D = 256 with Dv =
        # 128, and command-r-plus's G = 12 (the CUDA cores by the rule)
        (2, 70, 200, 4, 4, 192, 128, True, [0, 100], 0, [70, 170], True),
        (1, 100, 150, 2, 2, 192, 128, True, 0, 70, None, False),
        (3, 1, 1000, 4, 4, 192, 128, True, [0, 500, 999], 0,
         [1, 501, 1000], False),
        (1, 40, 100, 8, 4, 256, 128, True, 60, 0, None, False),
        (1, 30, 90, 24, 2, 128, 128, True, 60, 0, None, False),
    ]
    for (B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, valid, nan) in cases:
        for dt in tols:
            q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
            kk = torch.randn(B, Tk, KH, D, generator=g, device="cuda").to(dt)
            v = torch.randn(B, Tk, KH, Dv, generator=g, device="cuda").to(dt)
            qo = torch.tensor(off, dtype=torch.int32, device="cuda")
            vl = None if valid is None else torch.tensor(
                valid, dtype=torch.int32, device="cuda")
            kw = dict(causal=causal, q_offset=qo, prefix_len=pfx,
                      valid_len=vl)
            want = k.flash_attention_plain(q, kk, v, **kw)
            if nan:   # rows past valid_len hold NaN on the card only
                dead = (torch.arange(Tk, device="cuda")[None]
                        >= vl[:, None])[..., None, None]
                kk, v = kk.masked_fill(dead, float("nan")), \
                    v.masked_fill(dead, float("nan"))
            route = _attention_route(torch, dt, D, Dv, H // KH)
            got = _counted(kern, lambda: kern(q, kk, v, **kw), route)
            err = max_err(torch, got, want)
            check(bool(torch.isfinite(got).all())
                  and err <= tols[dt] * max(float(want.float().abs().max()),
                                            1e-6),
                  f"flash {B}x{Tq}x{Tk} H{H}/{KH} D{D}/{Dv} {dt} {route}: "
                  f"err {err}")
            grid = kern.last_grid
            if route == "wgmma" and Tk >= 1000:
                check(grid["splits"] > 1, f"flash: no key split ({grid})")
    # one layer of a stacked (ranks, L, B, S, KH, D) cache, per-slot
    # positions per rank, rows past valid_len holding NaN
    R, L, B, S, H, D = 2, 3, 2, 64, 16, 128
    cache = torch.randn(2, R, L, B, S, 1, D, generator=g,
                        device="cuda").to(torch.bfloat16)
    pos = torch.tensor([[3, 40], [63, 0]], dtype=torch.int32, device="cuda")
    rows = torch.arange(S, device="cuda").reshape(1, 1, S)
    dead = (rows > pos[..., None]).reshape(R, 1, B, S, 1, 1)
    clean = cache.masked_fill(dead, 0.0)
    dirty = cache.masked_fill(dead, float("nan"))
    q = torch.randn(R, B, 1, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    kw = dict(causal=True, q_offset=pos, valid_len=pos + 1)
    want = k.flash_attention_plain(q, clean[0, :, 1], clean[1, :, 1], **kw)
    got = _counted(kern, lambda: kern(q, dirty[0, :, 1], dirty[1, :, 1],
                                      **kw), "wgmma")
    err = max_err(torch, got, want)
    check(bool(torch.isfinite(got).all())
          and err <= 1.6e-2 * float(want.float().abs().max()),
          f"flash on a cache layer view: err {err}")
    before = kern.launches
    try:
        kern(q.float(), clean[0, :, 1], clean[1, :, 1], **kw)
        check(False, "flash: f32 q over a bf16 cache was not refused")
    except TypeError:
        pass
    check(kern.launches == before, "flash: a refused call counted a launch")
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    _refused_off_rule(fa_mod, kern, lambda: kern(
        q.float(), clean[0, :, 1].float(), clean[1, :, 1].float(), **kw),
        "flash")
    check_flash_combine(torch, k, g)


def check_flash_bwd(torch, k, g) -> None:
    """Flash attention's gradient kernel against its plain version
    (``flash_attention_bwd_plain``, the same formulas in plain torch) on
    ragged shapes: Tq and Tk off the 64-row tile and the key tile, D 64,
    80, 128 and 256 with Dv != D, G 1, 4 and 8, causal, prefix-LM (a
    window across key tiles), non-causal and a query offset, G = 1 at
    D = Dv = 80 across three causal 64-key tiles, and one case for each
    other instance width of the tensor-core route (W = max(D, Dv) 16, 32,
    48, 96 and 112), and the wide instance (D = 192: MLA's Dv 128 over one
    to three causal key tiles and two query tiles, a prefix window, Dv 64
    and 80 at G = 4 with a query offset and without the causal mask), and
    the 256-wide instance (D = Dv = 256 at G = 8, causal with a query
    offset and paligemma-3b's prefix-LM mask, a window across key tiles);
    f32, f16 and bf16, each case on the route ``attention_bwd_route``'s
    rule gives it (the 16-bit cases with D up to 128 or 192 and Dv up to
    128, or D = Dv = 256, on the tensor cores, f32 on the CUDA cores).
    Both take the
    plain forward's output and log-sum-exp; the forward kernel's lse
    (written on the route the rule gives the case) is held against the
    plain version's first.
    Tolerances, relative to each gradient's largest magnitude: f32 1e-4
    (sums of up to 300 terms a row, in another order), f16 2e-3 and bf16
    1.6e-2 (one ulp of the output type, 2^-10 / 2^-7, plus that order;
    the tensor cores also round P and dS to the operand type); lse within
    1e-4 (f32 scores summed in another order).  Two launches on the same
    inputs are equal bit for bit; an f32 launch forced onto the tensor
    cores is refused by the C entry, and the gradient's refusals hold."""
    tols = {torch.float32: 1e-4, torch.float16: 2e-3, torch.bfloat16: 1.6e-2}
    fwd, bwd = k.flash_attention_kernel, k.flash_attention_bwd_kernel
    cases = [
        # B, Tq, Tk, H, KH, D, Dv, causal, q_offset, prefix
        (2, 37, 37, 4, 4, 64, 64, True, 0, 0),
        (1, 70, 70, 8, 2, 80, 80, True, 0, 0),
        (2, 45, 45, 4, 1, 128, 64, True, 0, 20),
        (1, 33, 97, 8, 1, 256, 256, True, 64, 0),
        (1, 100, 100, 8, 8, 80, 48, True, 0, 70),
        (2, 29, 53, 4, 1, 64, 128, False, 0, 0),
        (1, 130, 130, 4, 1, 128, 128, True, 0, 0),
        (2, 130, 130, 4, 4, 80, 80, True, 0, 0),
        # the tensor-core route's other instance widths W = max(D, Dv)
        (1, 40, 40, 2, 1, 32, 16, True, 0, 0),
        (1, 50, 70, 4, 2, 48, 48, False, 0, 0),
        (1, 33, 33, 2, 2, 16, 96, True, 0, 0),
        (1, 64, 64, 2, 1, 112, 96, True, 0, 10),
        # the wide instance: D = 192 (deepseek-v3's MLA heads)
        (2, 70, 70, 4, 4, 192, 128, True, 0, 0),
        (1, 130, 130, 2, 2, 192, 128, True, 0, 0),
        (1, 100, 100, 2, 2, 192, 128, True, 0, 70),
        (1, 45, 97, 8, 2, 192, 64, True, 64, 0),
        (2, 29, 53, 4, 1, 192, 80, False, 0, 0),
        # the 256-wide instance under paligemma-3b's prefix-LM mask, G = 8
        (1, 150, 150, 8, 1, 256, 256, True, 0, 90),
    ]
    for (B, Tq, Tk, H, KH, D, Dv, causal, off, pfx) in cases:
        for dt in tols:
            q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
            kk = torch.randn(B, Tk, KH, D, generator=g, device="cuda").to(dt)
            v = torch.randn(B, Tk, KH, Dv, generator=g, device="cuda").to(dt)
            do = torch.randn(B, Tq, H, Dv, generator=g, device="cuda").to(dt)
            kw = dict(causal=causal, q_offset=off, prefix_len=pfx)
            o, lse = k.flash_attention_plain(q, kk, v, return_lse=True, **kw)
            route = _attention_route(torch, dt, D, Dv, H // KH)
            o_k, lse_k = _counted(fwd, lambda: fwd(q, kk, v, return_lse=True,
                                                   **kw), route)
            tag = f"flash bwd {B}x{Tq}x{Tk} H{H}/{KH} D{D}/{Dv} {dt}"
            l_err = max_err(torch, lse_k, lse)
            check(bool(torch.isfinite(lse_k).all()) and l_err <= 1e-4,
                  f"{tag}: forward lse on {route}: err {l_err}")
            check(fwd.last_grid["splits"] == 1,
                  f"{tag}: the forward split its keys with an lse")
            want = k.flash_attention_bwd_plain(q, kk, v, o, do, lse, **kw)
            b_route = _attention_bwd_route(torch, dt, D, Dv, H // KH)
            got = _counted(bwd, lambda: bwd(q, kk, v, o, do, lse, **kw),
                           b_route)
            again = bwd(q, kk, v, o, do, lse, **kw)
            for name, x, w, y in zip(("dq", "dk", "dv"), got, want, again):
                err = max_err(torch, x, w)
                scale = max(float(w.float().abs().max()), 1e-6)
                check(bool(torch.isfinite(x).all())
                      and err <= tols[dt] * scale,
                      f"{tag} {name} on {b_route}: err {err} (scale "
                      f"{scale})")
                check(torch.equal(x, y), f"{tag} {name}: two launches differ")
    q = torch.randn(2, 8, 4, 64, generator=g, device="cuda").requires_grad_()
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    for bad in (dict(valid_len=4),
                dict(q_offset=torch.tensor([0, 3], device="cuda"))):
        try:
            fa_mod.flash_attention_grad(q, q, q, **bad)
            check(False, f"flash with a gradient took {sorted(bad)}")
        except ValueError:
            pass
    x = torch.randn(1, 70, 4, 80, generator=g, device="cuda")
    lse = torch.zeros(1, 70, 4, device="cuda")
    _refused_off_rule(fa_mod, bwd, lambda: bwd(x, x, x, x, x, lse),
                      "flash bwd", rule_name="attention_bwd_route")


def _refused_off_rule(module, wrapper, call, what,
                      rule_name="attention_route", route="wgmma") -> None:
    """A launch off the rule (f32, or a shape the rule sends elsewhere)
    forced onto ``route`` (the module's rule patched to say so) is refused
    by the C entry point, not run; the wrapper's counts are restored
    after."""
    rule, counts = getattr(module, rule_name), (wrapper.launches,
                                                dict(wrapper.route_launches))
    setattr(module, rule_name, lambda *args: route)
    try:
        call()
        check(False, f"{what}: a launch off the rule on the {route} "
              f"route was not refused")
    except RuntimeError:
        pass
    finally:
        setattr(module, rule_name, rule)
        wrapper.launches, wrapper.route_launches = counts


def check_flash_combine(torch, k, g) -> None:
    """The split combine kernel against its plain version (``merge_states``
    folded in split order, then ``finalize_state``) on random partial
    states: some splits saw no key (m = -1e30, l = 0, acc = 0, as the
    kernel writes them), and one row saw none in any split.  Tolerance 2e-5
    of the output's scale in f32 (f32 exponentials against the plain
    version's float64 ones), one ulp plus that in bf16."""
    N, S, Tq, H, Dv = 6, 5, 3, 8, 128
    m = torch.randn(N, S, Tq, H, generator=g, device="cuda") * 4
    l = torch.rand(N, S, Tq, H, generator=g, device="cuda") * 9 + 0.5
    acc = torch.randn(N, S, Tq, H, Dv, generator=g, device="cuda") * 3
    empty = torch.rand(N, S, Tq, H, generator=g, device="cuda") < 0.3
    empty[0, :, 0, 0] = True
    m = m.masked_fill(empty, -1e30)
    l = l.masked_fill(empty, 0.0)
    acc = acc.masked_fill(empty[..., None], 0.0)
    before = k.flash_attention_kernel.combine_launches
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1.6e-2)):
        got = k.flash_combine_kernel(m, l, acc, dt)
        want = k.flash_combine_plain(m, l, acc, dt)
        err = max_err(torch, got, want)
        check(bool(torch.isfinite(got).all()) and bool((got[0, 0, 0] == 0)
                                                        .all())
              and err <= tol * float(want.float().abs().max()),
              f"flash combine {dt}: err {err}")
    check(k.flash_attention_kernel.combine_launches == before + 2,
          "flash combine: launches not counted")


def _routed_counts(torch, g, tokens, k, E_glob, E_loc, C):
    """Live rows of a rank's ``E_loc`` experts when ``tokens`` tokens each
    route to ``k`` of ``E_glob`` experts (top-k of random logits)."""
    logits = torch.randn(tokens, E_glob, generator=g, device="cuda")
    top = logits.topk(k, dim=-1).indices.reshape(-1)
    counts = torch.bincount(top, minlength=E_glob)[:E_loc]
    return counts.clamp(max=C).to(torch.int32)


def _expert_case(torch, g, shape, dt, counts, lead=()):
    """Rows below each expert's count random, the rest zero (the dispatch
    layouts); weights scaled for outputs of order one."""
    E, C, d, f = shape
    x = torch.randn(*lead, E, C, d, generator=g, device="cuda")
    live = torch.arange(C, device="cuda") < counts[..., None]
    x = (x * live[..., None]).to(dt)
    ws = [(torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5),
          (torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5),
          (torch.randn(E, f, d, generator=g, device="cuda") * f ** -0.5)]
    return x, [w.to(dt) for w in ws], live


def _expert_route(torch, dt, d, f) -> str:
    """The route an expert-MLP case's aligned, contiguous operands must
    take: the tensor cores for f16/bf16 with d and f multiples of 64, the
    CUDA cores otherwise (plan.expert_route's rule, restated here so the
    checks hold it)."""
    return ("wgmma" if dt in (torch.float16, torch.bfloat16)
            and d % 64 == 0 and f % 64 == 0 else "simt")


def check_expert_mlp(torch, k, g) -> None:
    """The grouped expert MLP in f32 and bf16 at a small shape and at the
    serving path's decode (64, 2, 4096, 1536) and chunk (64, 256, 4096,
    1536) blocks, with live rows from a real top-k routing; bf16 blocks of
    C = 2, 20 and 256 rows whose experts hold 0, 1, C and (at C = 256) 129
    live rows; bf16 at a d and at an f off the tensor-core rule.  Each case
    on the route the rule gives it; rows past the counts must be exactly 0.
    Tolerance, relative to the output's largest magnitude: f32 1e-5 (sums
    in another order), bf16 1.6e-2 (one ulp of the output and of the
    rounded h, plus the order).  Also: the same call without counts gives
    the same bits (skipping zero rows is exact), rank x source blocks over
    a layer view of stacked weights, and a launch off the rule forced onto
    the tensor cores is refused."""
    tols = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    cases = [((8, 64, 256, 128), 64, 2, 8),          # E, C, d, f; t, k, E_glob
             ((64, 2, 4096, 1536), 2, 8, 128),
             ((64, 256, 4096, 1536), 256, 8, 128)]
    for shape, t, kk, E_glob in cases:
        E, C = shape[:2]
        counts = _routed_counts(torch, g, t, kk, E_glob, E, C)
        for dt, tol in tols.items():
            x, ws, live = _expert_case(torch, g, shape, dt, counts)
            route = _expert_route(torch, dt, *shape[2:])
            want = k.expert_mlp_plain(x, *ws, counts)
            got = _counted(k.expert_mlp, lambda: k.expert_mlp(x, *ws, counts),
                           route)
            err = max_err(torch, got, want)
            check(err <= tol * float(want.float().abs().max()),
                  f"expert_mlp {shape} {dt} {route}: err {err}")
            check(not got[~live].any(), f"expert_mlp {shape} {dt}: rows past "
                  "the counts are not zero")
            if shape[0] == 8:
                check(torch.equal(k.expert_mlp(x, *ws), got),
                      f"expert_mlp {shape} {dt}: counts changed live rows")
            del x, ws, want, got
    # live counts of 0, 1 and C (and 129: a second row tile of one row) on
    # the tensor cores, and d or f off the rule on the CUDA cores
    for shape in ((6, 2, 256, 128), (6, 20, 192, 320), (8, 256, 256, 128),
                  (6, 20, 200, 128), (6, 20, 256, 96)):
        E, C = shape[:2]
        lives = [0, 1, C, 1, C, 0, 129, C][:E]
        counts = torch.tensor([min(n, C) for n in lives], dtype=torch.int32,
                              device="cuda")
        x, ws, live = _expert_case(torch, g, shape, torch.bfloat16, counts)
        route = _expert_route(torch, torch.bfloat16, *shape[2:])
        want = k.expert_mlp_plain(x, *ws, counts)
        got = _counted(k.expert_mlp, lambda: k.expert_mlp(x, *ws, counts),
                       route)
        err = max_err(torch, got, want)
        check(err <= 1.6e-2 * float(want.float().abs().max())
              and not got[~live].any(),
              f"expert_mlp {shape} counts {counts.tolist()} {route}: "
              f"err {err}")
    # (ranks, sources) blocks sharing each rank's weights, the weights one
    # layer of a stacked (ranks, L, E, d, f) tensor; f32, then bf16
    E, C, d, f = 8, 20, 128, 64
    counts = torch.randint(0, C + 1, (2, 3, E), generator=g, device="cuda",
                           dtype=torch.int32)
    for dt, tol in tols.items():
        x, _, live = _expert_case(torch, g, (E, C, d, f), dt, counts,
                                  lead=(2, 3))
        stacked = [(torch.randn(2, 3, E, a, b, generator=g, device="cuda")
                    * a ** -0.5).to(dt) for a, b in ((d, f), (d, f), (f, d))]
        ws = [w[:, 1] for w in stacked]
        want = k.expert_mlp_plain(x, *ws, counts)
        got = _counted(k.expert_mlp, lambda: k.expert_mlp(x, *ws, counts),
                       _expert_route(torch, dt, d, f))
        err = max_err(torch, got, want)
        check(err <= tol * float(want.float().abs().max())
              and not got[~live].any(),
              f"expert_mlp over ranks x sources on a layer view {dt}: "
              f"err {err}")
    from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
    for dt, shape in ((torch.float32, (8, 20, 128, 64)),
                      (torch.bfloat16, (6, 20, 256, 96))):
        x, ws, _ = _expert_case(torch, g, shape, dt, counts[0, 0, :shape[0]])
        _refused_off_rule(mlp_mod, k.expert_mlp,
                          lambda: k.expert_mlp(x, *ws),
                          f"expert_mlp {shape} {dt}", "expert_route")


def check_moe_dispatch(torch, k, g) -> None:
    """The fused dispatch on ep = 2 and 4 virtual ranks (and two rings of 2
    side by side) under imbalanced routing, fused and host schedules, with
    a load-sized plan and the worst-case plan the serving path takes:
    nothing dropped, the combined output equal bit for bit to the
    emulation run with the expert-MLP kernel as its MLP, and within the
    expert MLP's tolerance of the emulation with the plain MLP.  A starved
    plan drops rows and still equals the emulation.  f32 runs on the CUDA
    cores, bf16 (d = 256, f = 128) on the tensor cores, each launch checked
    on its route; a launch off the rule forced onto the tensor cores is
    refused."""
    import dataclasses
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.moe_dispatch.ref import (measure_expert_load,
                                                      route_topk)
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh

    tols = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    E, t_loc, d, f, kk = 16, 24, 256, 128, 2
    for axes, sizes in ((("x",), (2,)), (("x",), (4,)),
                        (("data", "x"), (2, 2))):
        mesh = RankMesh(axes, sizes)
        ep = sizes[-1]
        group = DiompGroup(("x",), name="ep")
        for dt, tol in tols.items():
            toks = torch.randn(*sizes, t_loc, d, generator=g, device="cuda")
            router = (torch.randn(d, E, generator=g, device="cuda")
                      + 2.0 * torch.randn(1, E, generator=g, device="cuda"))
            top_w, top_e = route_topk(toks, router, kk)
            toks = toks.to(dt)
            ws = [(torch.randn(*sizes, E // ep, a, b, generator=g,
                               device="cuda") * a ** -0.5).to(dt)
                  for a, b in ((d, f), (d, f), (f, d))]
            loads = measure_expert_load(top_e.reshape(-1, t_loc, kk), E)
            planner = OverlapPlanner()
            plans = [planner.plan_alltoall(t_loc, d, kk, E, ep, dt,
                                           loads=loads),
                     planner.plan_alltoall(t_loc, d, kk, E, ep, dt),
                     planner.plan_alltoall(t_loc, d, kk, E, ep, dt,
                                           overlap=False)]
            check(max(loads) > 2 * min(loads), f"routing not skewed: {loads}")
            starved = dataclasses.replace(plans[0], caps=(2,) * E)
            with use_default(DiompContext(mesh=mesh, device="cuda")):
                for p in plans + [starved]:
                    args = (toks, top_e, top_w, *ws, group)
                    kern = k.fused_moe_dispatch_kernel
                    got, dropped = _counted(kern, lambda: kern(*args, plan=p),
                                            _expert_route(torch, dt, d, f))
                    emu, _ = k.fused_moe_dispatch_interpret(
                        *args, plan=p, mlp=k.expert_mlp)
                    plain, _ = k.fused_moe_dispatch_plain(*args, plan=p)
                    err = max_err(torch, got, plain)
                    name = (f"moe_dispatch {axes}{sizes} {dt} caps "
                            f"{p.cap_pad} overlap {p.overlap}")
                    check(torch.equal(got, emu), f"{name}: differs from the "
                          "emulation through the expert-MLP kernel")
                    check(err <= tol * float(plain.float().abs().max()),
                          f"{name}: err {err}")
                    check(bool((dropped > 0).any()) == (p is starved),
                          f"{name}: dropped {dropped.tolist()}")
                if dt == torch.float32 and len(sizes) == 1:
                    from repro_torch.kernels.moe_dispatch import fused
                    _refused_off_rule(
                        fused, kern, lambda: kern(*args, plan=plans[0]),
                        f"moe_dispatch {sizes} {dt}", "expert_route")
        # bf16 with f off the rule: the CUDA cores, and refused on the
        # tensor cores
        with use_default(DiompContext(mesh=mesh, device="cuda")):
            toks = torch.randn(*sizes, t_loc, d, generator=g,
                               device="cuda").to(torch.bfloat16)
            top_w, top_e = route_topk(toks, router, kk)
            ws = [(torch.randn(*sizes, E // ep, a, b, generator=g,
                               device="cuda") * a ** -0.5).to(torch.bfloat16)
                  for a, b in ((d, 96), (d, 96), (96, d))]
            p = OverlapPlanner().plan_alltoall(t_loc, d, kk, E, ep,
                                               torch.bfloat16)
            args = (toks, top_e, top_w, *ws, group)
            kern = k.fused_moe_dispatch_kernel
            got, _ = _counted(kern, lambda: kern(*args, plan=p), "simt")
            emu, _ = k.fused_moe_dispatch_interpret(*args, plan=p,
                                                    mlp=k.expert_mlp)
            check(torch.equal(got, emu), f"moe_dispatch {sizes} f = 96: "
                  "differs from the emulation through the expert-MLP kernel")
            from repro_torch.kernels.moe_dispatch import fused
            _refused_off_rule(fused, kern, lambda: kern(*args, plan=p),
                              f"moe_dispatch {sizes} f = 96", "expert_route")


def _bwd_case(torch, g, G, S, E, C, d, f, dt, counts):
    """Row 12's operands: rows below each count random in x and dy, the
    rest zero (the dispatch layouts), weights scaled for g and u of order
    one; ``counts (G, S, E)``."""
    live = torch.arange(C, device="cuda") < counts[..., None]
    x = (torch.randn(G, S, E, C, d, generator=g, device="cuda")
         * live[..., None]).to(dt)
    dy = (torch.randn(G, S, E, C, d, generator=g, device="cuda")
          * live[..., None]).to(dt)
    ws = [(torch.randn(G, E, a, b, generator=g, device="cuda")
           * a ** -0.5).to(dt) for a, b in ((d, f), (d, f), (f, d))]
    return x, ws, dy, live


def _bwd_close(torch, got, want, again, tol, tag):
    """Each of (dx, dwg, dwu, dwd) within ``tol`` of its plain version's
    largest magnitude, and two launches equal bit for bit; returns the
    worst relative error.  ``again`` is the second launch's outputs, or a
    function that launches it, called once ``want`` is released (the
    caller passes its only reference where three sets of a training call's
    gradients do not fit beside its operands)."""
    worst = 0.0
    names = ("dx", "dwg", "dwu", "dwd")
    want = list(want)
    for i, (name, x) in enumerate(zip(names, got)):
        w = want[i]
        err = max_err(torch, x, w)
        scale = max(float(w.abs().max()), 1e-6)
        worst = max(worst, err / scale)
        check(x.shape == w.shape and bool(torch.isfinite(x).all())
              and err <= tol * scale,
              f"{tag} {name}: err {err} (scale {scale})")
    del w
    want.clear()
    for name, x, y in zip(names, got, again() if callable(again) else again):
        check(torch.equal(x, y), f"{tag} {name}: two launches differ")
    return worst


def check_expert_mlp_bwd(torch, k, g) -> None:
    """The expert MLP's gradient kernel (row 12) against its plain version
    (``expert_mlp_bwd_plain``): bf16 on the tensor cores and f32 on the
    CUDA cores; experts holding 0, 1, C - 1 and C live rows; C of 20, 80
    and 130 (off the 64-row tile); S = 1 and 2 sources over G = 1 and 2
    ranks, the weights one layer of a stacked tensor; a bf16 d off the rule
    on the CUDA cores.  Tolerances, relative to each gradient's largest
    magnitude: f32 1e-5 (sums in another order), bf16 1.6e-2 (one ulp of
    the output and of the rounded dg, du and h, plus the order).  Rows past
    the counts come out as exact zeros, two launches on the same inputs
    are equal bit for bit, and a launch off the rule forced onto the
    tensor cores is refused.  On the tensor cores an expert's live rows
    over its sources are packed in 64-row tiles: the cases hold experts of
    0, 1, 2, 3 and 5 such tiles (C = 130: 1, 130 and 259 rows; 5 tiles are
    more than the dW pass's slots hold)."""
    from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
    tols = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    bwd = k.expert_mlp_bwd
    packed = []
    for G, S, E, C, d, f in ((1, 1, 4, 20, 128, 64), (2, 2, 4, 80, 256, 128),
                             (1, 2, 3, 130, 192, 320)):
        lives = [0, 1, C - 1, C, C, 1, 0, C - 1]
        counts = torch.tensor([[[lives[(gi + si + e) % 8] for e in range(E)]
                                for si in range(S)] for gi in range(G)],
                              dtype=torch.int32, device="cuda")
        packed += counts.sum(1).flatten().tolist()
        for dt, tol in tols.items():
            x, ws, dy, live = _bwd_case(torch, g, G, S, E, C, d, f, dt,
                                        counts)
            stacked = [torch.stack([w, w.flip(0)], dim=1) for w in ws]
            ws = [w[:, 0] for w in stacked]          # a layer view
            route = _expert_route(torch, dt, d, f)
            want = k.expert_mlp_bwd_plain(x, *ws, dy, counts)
            got = _counted(bwd, lambda: bwd(x, *ws, dy, counts), route)
            again = bwd(x, *ws, dy, counts)
            tag = f"expert_mlp_bwd {(G, S, E, C, d, f)} {dt} {route}"
            _bwd_close(torch, got, want, again, tol, tag)
            check(not got[0][~live].any(),
                  f"{tag}: dx rows past the counts are not zero")
            del x, ws, dy, want, got, again, stacked
    tiles = sorted({-(-n // 64) for n in packed})
    check(tiles[0] == 0 and tiles[-1] > 2,
          f"expert_mlp_bwd: the cases' experts pack into {tiles} tiles")
    # bf16 with d off the rule: the CUDA cores, and refused on the tensor
    # cores
    counts = torch.tensor([[[3, 0, 20]]], dtype=torch.int32, device="cuda")
    x, ws, dy, _ = _bwd_case(torch, g, 1, 1, 3, 20, 200, 64, torch.bfloat16,
                             counts)
    want = k.expert_mlp_bwd_plain(x, *ws, dy, counts)
    got = _counted(bwd, lambda: bwd(x, *ws, dy, counts), "simt")
    _bwd_close(torch, got, want, bwd(x, *ws, dy, counts), 1.6e-2,
               "expert_mlp_bwd d = 200 bf16 simt")
    _refused_off_rule(mlp_mod, bwd, lambda: bwd(x, *ws, dy, counts),
                      "expert_mlp_bwd d = 200", "expert_bwd_route")
    x, ws, dy, _ = _bwd_case(torch, g, 1, 1, 3, 20, 128, 64, torch.float32,
                             counts)
    _refused_off_rule(mlp_mod, bwd, lambda: bwd(x, *ws, dy, counts),
                      "expert_mlp_bwd f32", "expert_bwd_route")


def check_moe_dispatch_bwd(torch, k, g) -> None:
    """The fused dispatch's gradient kernel (row 13) on ep = 2 and 4
    virtual rings (and two rings of 2 side by side) under imbalanced
    routing, on the overlapped and the serialized schedule with a
    load-sized and the worst-case plan: the block-level gradient (dbuf and
    the three dW) against its plain version (``fused_dispatch_bwd_plain``)
    and two launches equal bit for bit; then the whole op's gradient with
    respect to the tokens, the router's gate weights and the experts
    through ``FusedDispatchFn`` against the emulation's autograd (the plain
    expert MLP), the same twice over bit for bit.  f32 on the CUDA cores,
    bf16 (d = 256, f = 128) on the tensor cores; tolerances as row 12's.
    A launch off the rule forced onto the tensor cores is refused."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.moe_dispatch import fused
    from repro_torch.kernels.moe_dispatch.ref import (measure_expert_load,
                                                      route_topk)
    from repro_torch.kernels.plan import OverlapPlanner

    from repro_torch.launch.mesh import RankMesh
    tols = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    E, t_loc, d, f, kk = 16, 24, 256, 128, 2
    bwd = k.fused_dispatch_bwd_kernel
    for axes, sizes in ((("x",), (2,)), (("x",), (4,)),
                        (("data", "x"), (2, 2))):
        mesh = RankMesh(axes, sizes)
        ep = sizes[-1]
        group = DiompGroup(("x",), name="ep")
        for dt, tol in tols.items():
            toks = torch.randn(*sizes, t_loc, d, generator=g, device="cuda")
            router = (torch.randn(d, E, generator=g, device="cuda")
                      + 2.0 * torch.randn(1, E, generator=g, device="cuda"))
            top_w, top_e = route_topk(toks, router, kk)
            toks = toks.to(dt)
            ws = [(torch.randn(*sizes, E // ep, a, b, generator=g,
                               device="cuda") * a ** -0.5).to(dt)
                  for a, b in ((d, f), (d, f), (f, d))]
            loads = measure_expert_load(top_e.reshape(-1, t_loc, kk), E)
            planner = OverlapPlanner()
            plans = [planner.plan_alltoall(t_loc, d, kk, E, ep, dt,
                                           loads=loads),
                     planner.plan_alltoall(t_loc, d, kk, E, ep, dt),
                     planner.plan_alltoall(t_loc, d, kk, E, ep, dt,
                                           overlap=False)]
            route = _expert_route(torch, dt, d, f)
            cot = torch.randn(*sizes, t_loc, d, generator=g,
                              device="cuda").to(dt)
            with use_default(DiompContext(mesh=mesh, device="cuda")):
                for p in plans:
                    name = (f"moe_dispatch_bwd {axes}{sizes} {dt} caps "
                            f"{p.cap_pad} overlap {p.overlap}")
                    buf, _, _, _, counts = fused.dispatch_buffers(
                        toks, top_e, top_w, p)
                    dfull = torch.randn(buf.shape, generator=g,
                                        device="cuda").to(dt)
                    live = (torch.arange(p.cap_pad, device="cuda")
                            < counts[..., None])[..., None]
                    dfull = dfull * live
                    args = (buf, *ws, counts, dfull, group)
                    want = k.fused_dispatch_bwd_plain(*args)
                    got = _counted(bwd, lambda: bwd(*args, plan=p), route)
                    _bwd_close(torch, got, want, bwd(*args, plan=p), tol,
                               name)
                    # the whole op under autograd, against the emulation's
                    runs = []
                    for mode in ("kernel", "kernel", "emulation"):
                        leaves = [t.detach().clone().requires_grad_()
                                  for t in (toks, top_w, *ws)]
                        a = (leaves[0], top_e, *leaves[1:], group)
                        if mode == "kernel":
                            out, _ = k.fused_moe_dispatch_kernel(*a, plan=p)
                        else:
                            out, _ = k.fused_moe_dispatch_interpret(
                                *a, plan=p, mlp=k.expert_mlp_plain)
                        out.backward(cot)
                        runs.append([t.grad for t in leaves])
                    for i, (x, y, w) in enumerate(zip(*runs)):
                        err = max_err(torch, x, w)
                        scale = max(float(w.float().abs().max()), 1e-6)
                        check(torch.equal(x, y), f"{name}: grad {i} differs "
                              "between two equal steps")
                        check(err <= tol * scale, f"{name}: grad {i} err "
                              f"{err} against the emulation (scale {scale})")
                if dt == torch.float32 and len(sizes) == 1:
                    _refused_off_rule(fused, bwd, lambda: bwd(*args, plan=p),
                                      f"moe_dispatch_bwd {sizes} {dt}",
                                      "expert_bwd_route")


def _scan_inputs(torch, g, BH, T, M, N, decay):
    """Scan operands of order one; ``decay`` is a fixed a or None (a drawn
    from [0.7, 0.999], the reference sweep's range)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.5
    a = (torch.full((BH, T, N), decay, device="cuda") if decay is not None
         else 0.7 + 0.299 * torch.rand(BH, T, N, generator=g, device="cuda"))
    return rnd(BH, T, M), rnd(BH, T, N), a, rnd(BH, T, N)


def _scan_err(torch, got, want):
    """Each output's max |err| over its largest magnitude."""
    return max(max_err(torch, gt, w) / max(float(w.abs().max()), 1e-30)
               for gt, w in zip(got, want))


def check_linear_scan(torch, k, g) -> None:
    """The scan kernel against the sequential scan on both routes (decode
    at T = 1, prefill otherwise): both readouts, ragged and whole chunks
    and sub-chunks (T = 15, 16, 17, 37, 64, 65, 130), zero and carried
    states, decays from the reference sweep's [0.7, 0.999] and fixed at
    e^-1 and e^-8 (where the reference's clamped Pallas kernel fails), M =
    N = 64 at chunks of 64 and 32, a narrow ragged shape at chunk 16 and
    widths off 4 (scalar copies).  Tolerance 2e-4 of each output's largest
    magnitude, the reference's bound for the chunked form against the
    sequential scan (tests/test_kernels.py:99-103); every output finite.
    Operands that are not contiguous float32 are refused without a launch,
    and so is a T > 1 call forced onto the decode route."""
    from repro_torch.kernels.linear_scan import kernel as ls_mod
    for (BH, M, N, chunk) in ((3, 64, 64, 64), (2, 64, 64, 32),
                              (2, 16, 40, 16), (2, 18, 37, 64)):
        for T in (1, 15, 16, 17, 37, 64, 65, 130):
            for decay in (None, math.exp(-1.0), math.exp(-8.0)):
                p, q, a, r = _scan_inputs(torch, g, BH, T, M, N, decay)
                for s0 in (None, torch.randn(BH, M, N, generator=g,
                                             device="cuda")):
                    for pre in (True, False):
                        want = k.linear_scan_plain(p, q, a, r, s0,
                                                   readout_pre=pre)
                        kern = k.linear_scan_kernel
                        got = _counted(kern, lambda: kern(
                            p, q, a, r, s0, readout_pre=pre, chunk=chunk),
                            "decode" if T == 1 else "prefill")
                        err = _scan_err(torch, got, want)
                        check(all(bool(torch.isfinite(t).all()) for t in got)
                              and err <= 2e-4,
                              f"linear_scan BH{BH} T{T} M{M} N{N} chunk "
                              f"{chunk} decay {decay} s0 {s0 is not None} "
                              f"pre {pre}: relative err {err:.3g}")
    before = k.linear_scan_kernel.launches
    for bad in (p.to(torch.bfloat16), p.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        try:
            k.linear_scan_kernel(bad, q, a, r)
            check(False, "linear_scan: a bf16 or strided p was not refused")
        except TypeError:
            pass
    check(k.linear_scan_kernel.launches == before,
          "linear_scan: a refused call counted a launch")
    _refused_off_rule(ls_mod, k.linear_scan_kernel,
                      lambda: k.linear_scan_kernel(p, q, a, r), "linear_scan",
                      rule_name="scan_route", route="decode")


def _scan_bwd_err(torch, got, want):
    """Each gradient's max |err| over its largest magnitude (a zero
    gradient matched exactly)."""
    worst = 0.0
    for x, w in zip(got, want):
        err, scale = max_err(torch, x, w), float(w.abs().max())
        worst = max(worst, err / scale if scale else err)
    return worst


def check_linear_scan_bwd(torch, k, g) -> None:
    """Row 11, the scan's backward, against its plain version (the reverse
    sequential scan, with dla = a * da, 0 where a < 1e-38): both readouts,
    T across the edges of its 16-row sub-chunks and 32-row chunks, whole
    and ragged (T = 1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 130), zero
    and given s0 with no and a given cotangent of s_final, decays from the
    reference sweep's [0.7, 0.999], fixed at e^-1, e^-8 and e^-30, and a
    row of decays 0, 1e-40 and 1e-39, M = N = 64 and narrow ragged widths.
    Tolerance 2e-4 of each gradient's largest magnitude, the forward's
    bound for the chunked form against the sequential scan (dla's terms
    carry a_t's factor, so strong decays cancel nothing); every gradient
    finite, dla 0 on the tiny decays; one launch a
    call; a second call on equal inputs gives equal bits (no atomics).
    Operands that are not contiguous float32 are refused without a
    launch."""
    kern = k.linear_scan_bwd_kernel
    for (BH, M, N) in ((3, 64, 64), (2, 16, 40), (2, 18, 37)):
        for T in (1, 15, 16, 17, 31, 32, 33, 37, 63, 64, 65, 130):
            for decay in (None, math.exp(-1.0), math.exp(-8.0),
                          math.exp(-30.0), "tiny"):
                p, q, a, r = _scan_inputs(
                    torch, g, BH, T, M, N, None if decay == "tiny" else decay)
                if decay == "tiny":
                    a[:, T // 2, :3] = torch.tensor([0.0, 1e-40, 1e-39],
                                                    device=a.device)
                dy = torch.randn(BH, T, M, generator=g, device="cuda")
                for given in (False, True):
                    s0, ds = ((torch.randn(BH, M, N, generator=g,
                                           device="cuda") for _ in range(2))
                              if given else (None, None))
                    for pre in (True, False):
                        args = (p, q, a, r, s0, dy, ds)
                        want = k.linear_scan_bwd_plain(*args,
                                                       readout_pre=pre)
                        got = _counted(kern, lambda: kern(
                            *args, readout_pre=pre), "chunked")
                        err = _scan_bwd_err(torch, got, want)
                        what = (f"linear_scan_bwd BH{BH} T{T} M{M} N{N} "
                                f"decay {decay} s0/ds_fin {given} pre {pre}")
                        check(all(bool(torch.isfinite(t).all()) for t in got)
                              and err <= 2e-4,
                              f"{what}: relative err {err:.3g}")
                        if decay == "tiny":
                            check(not bool(got[2][:, T // 2, :3].any()),
                                  f"{what}: dla not 0 on the tiny decays")
    again = kern(*args, readout_pre=pre)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "linear_scan_bwd: two calls on equal inputs differ")
    before = kern.launches
    for bad in (p.to(torch.bfloat16), p.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        try:
            kern(bad, q, a, r, None, dy)
            check(False, "linear_scan_bwd: a bf16 or strided p was not "
                  "refused")
        except TypeError:
            pass
    check(kern.launches == before,
          "linear_scan_bwd: a refused call counted a launch")


def _ring_layout(t, n, sharded):
    """Full ``(B, T, ...)`` -> the ring's stacked ``(n, B, T/n, ...)``
    (or, unsharded, ``n`` copies)."""
    if sharded:
        return t.unflatten(1, (n, t.shape[1] // n)).movedim(1, 0).contiguous()
    return t.expand(n, *t.shape).contiguous()


def check_ring_attention(torch, k, g) -> None:
    """The ring kernel against ``ring_attention_ref`` at ragged shapes:
    rings of 1-4 virtual ranks, both query layouts (sharded, and shared
    queries over striped keys as in chunked prefill), causal and not, int
    and per-row offsets, a valid length below the padded one, G = 1 and 8,
    head_dim 64, 80, 192 (Dv 128) and 256, Dv != D; f32 and bf16, each case on the route
    the rule gives it.  Every rank's output is held to the plain version (rank
    0's fold order); operands of mixed dtypes are refused."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh
    tols = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
    group = DiompGroup(("x",), name="x")
    kern = k.fused_ring_attention_kernel
    cases = [
        # n, B, tq, tk, H, KH, D, Dv, q_sharded, causal, q_offset, valid_len
        (1, 2, 20, 20, 4, 4, 64, 64, True, True, 0, None),
        (2, 1, 33, 33, 8, 1, 256, 256, True, True, 0, None),
        (3, 2, 10, 17, 8, 1, 64, 64, True, False, 0, 45),
        (4, 1, 16, 12, 8, 1, 256, 256, False, True, 30, 46),
        (2, 2, 24, 40, 8, 1, 64, 48, False, True, [50, 20], [74, 44]),
        (4, 2, 7, 13, 4, 4, 256, 256, True, True, [0, 9], [52, 40]),
        (3, 1, 70, 70, 8, 1, 64, 64, False, False, 100, 150),
        # stripes of several key tiles, ragged, past the valid length
        (2, 1, 130, 150, 8, 1, 128, 128, True, True, 0, 290),
        (2, 2, 40, 100, 16, 1, 128, 128, False, True, [60, 10], [100, 170]),
        # head_dim 80 (two 64-column boxes, the second partly filled)
        (2, 2, 40, 100, 8, 2, 80, 80, False, True, [60, 10], [100, 170]),
        # MLA's D = 192, Dv = 128 (three boxes of q and k)
        (2, 2, 40, 100, 4, 4, 192, 128, False, True, [60, 10], [100, 170]),
    ]
    for (n, B, tq, tk, H, KH, D, Dv, sharded, causal, off, valid) in cases:
        ctx = DiompContext(mesh=RankMesh(("x",), (n,)), device="cuda")
        for dt, tol in tols.items():
            q = torch.randn(B, n * tq if sharded else tq, H, D, generator=g,
                            device="cuda").to(dt)
            kk = torch.randn(B, n * tk, KH, D, generator=g,
                             device="cuda").to(dt)
            v = torch.randn(B, n * tk, KH, Dv, generator=g,
                            device="cuda").to(dt)
            qo = torch.tensor(off, dtype=torch.int32, device="cuda")
            vl = None if valid is None else torch.tensor(
                valid, dtype=torch.int32, device="cuda")
            want = k.ring_attention_ref(q, kk, v, n=n, causal=causal,
                                        q_offset=qo, valid_len=vl,
                                        q_sharded=sharded)
            plan = OverlapPlanner().plan_ring_attention(
                B, tq, tk, H, KH, D, Dv, dt, n, causal=causal,
                q_sharded=sharded, q_offset=None)
            args = (_ring_layout(q, n, sharded), _ring_layout(kk, n, True),
                    _ring_layout(v, n, True))
            route = _attention_route(torch, dt, D, Dv, H // KH)
            with use_default(ctx):
                got = _counted(kern, lambda: kern(*args, group, plan=plan,
                                                  q_offset=qo, valid_len=vl),
                               route)
            if sharded:
                got = got.movedim(0, 1).flatten(1, 2)[None]
            err = max(max_err(torch, r, want) for r in got)
            check(bool(torch.isfinite(got).all())
                  and err <= tol * max(float(want.float().abs().max()), 1e-6),
                  f"ring attention n={n} B{B} tq{tq} tk{tk} H{H}/{KH} D{D}/"
                  f"{Dv} sharded={sharded} causal={causal} {dt} {route}: "
                  f"err {err}")
    before = kern.launches
    try:
        with use_default(ctx):
            kern(args[0].float(), args[1], args[2], group, plan=plan)
        check(False, "ring attention: f32 q over bf16 k/v was not refused")
    except TypeError:
        pass
    check(kern.launches == before, "ring attention: a refused call counted "
          "a launch")
    from repro_torch.kernels.ring_attention import fused as ra_mod
    with use_default(ctx):
        _refused_off_rule(ra_mod, kern, lambda: kern(
            args[0].float(), args[1].float(), args[2].float(), group,
            plan=plan), "ring attention")


RING_BWD_CASES = [
    # n, B, tq, tk, H, KH, D, Dv, q_sharded, causal, q_offset, valid_len
    (1, 2, 20, 20, 4, 4, 64, 64, True, True, 0, None),
    (2, 1, 33, 33, 8, 1, 256, 256, True, True, 0, None),
    (3, 2, 10, 17, 8, 1, 64, 64, True, False, 0, 45),
    (4, 1, 16, 12, 8, 1, 256, 256, False, True, 30, 46),
    (2, 2, 24, 40, 8, 1, 64, 48, False, True, [50, 20], [74, 44]),
    (4, 2, 7, 13, 4, 4, 256, 256, True, True, [0, 9], [52, 40]),
    (3, 1, 70, 70, 8, 1, 64, 64, False, False, 100, 150),
    # stripes of several key tiles, ragged, past the valid length
    (2, 1, 130, 150, 8, 1, 128, 128, True, True, 0, 290),
    # head_dim 80, and MLA's D = 192 with Dv = 128
    (2, 2, 40, 100, 8, 2, 80, 80, False, True, [60, 10], [100, 170]),
    (2, 2, 40, 100, 4, 4, 192, 128, True, True, 0, 190),
    # the tensor cores' other widths W = max(D, Dv), G 16 and 64
    (3, 1, 50, 70, 16, 1, 32, 16, True, True, 0, None),
    (2, 1, 64, 64, 64, 1, 16, 96, True, True, 0, 120),
    (4, 1, 30, 30, 4, 2, 112, 48, True, False, 0, None),
]


def _ring_bwd_route(torch, dt, D, Dv, G) -> str:
    """The route a ring-gradient case's aligned, contiguous operands must
    take: the tensor cores for f16/bf16 with D and Dv multiples of 16 in
    [16, 128], or D = Dv = 256 (the 256-wide instance), and G dividing 64,
    the CUDA cores otherwise (fused.py's ring_bwd_route, row 10's rule
    without its wide instance, restated here so the cases check it)."""
    return ("wgmma" if dt in (torch.float16, torch.bfloat16)
            and (all(16 <= x <= 128 and x % 16 == 0 for x in (D, Dv))
                 or D == Dv == 256)
            and 64 % G == 0 else "simt")


def check_ring_attention_bwd(torch, k, g) -> None:
    """Row 14, the ring's gradient kernel, against its plain version (the
    emulation's chain-form backward, ``fused_ring_attention_bwd_plain``, on
    the same card tensors) at ``check_ring_attention``'s ragged shapes:
    rings of 1-4 virtual ranks, both query layouts, causal and not, int and
    per-row offsets, a valid length below the padded one, G = 1, 4 and 8,
    D 64, 80, 128, 192 (Dv 128) and 256, Dv != D; f32 and bf16, each case
    on the route ``ring_bwd_route``'s rule gives it (bf16 with D and Dv up
    to 128, or D = Dv = 256, on the tensor cores, the rest on the CUDA
    cores).  The lse comes
    from row
    9 (``return_lse``, on the route the rule gives the case) and is held
    against the plain version's first: within 1e-4, +inf exactly where a
    row sees no key.  Tolerances, relative to each gradient's largest
    magnitude: f32 1e-4 (sums in another order: the kernel takes the
    global lse, the plain version folds per-stripe states), bf16 1.6e-2
    (one ulp of the output type, 2^-7, plus that order; the tensor cores
    also round P and dS to bf16).  Two launches on the same inputs are
    equal bit for bit, the autograd path (``RingAttentionFn``) gives the
    same bits, mixed dtypes are refused and an f32 launch forced onto the
    tensor cores is refused by the C entry."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.kernels.ring_attention import fused as ra_mod
    from repro_torch.launch.mesh import RankMesh
    tols = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
    group = DiompGroup(("x",), name="x")
    fwd, bwd = k.fused_ring_attention_kernel, k.fused_ring_attention_bwd_kernel
    for (n, B, tq, tk, H, KH, D, Dv, sharded, causal, off, valid) in \
            RING_BWD_CASES:
        ctx = DiompContext(mesh=RankMesh(("x",), (n,)), device="cuda")
        for dt, tol in tols.items():
            q = torch.randn(n, B, tq, H, D, generator=g, device="cuda").to(dt)
            kk = torch.randn(n, B, tk, KH, D, generator=g,
                             device="cuda").to(dt)
            v = torch.randn(n, B, tk, KH, Dv, generator=g,
                            device="cuda").to(dt)
            do = torch.randn(n, B, tq, H, Dv, generator=g,
                             device="cuda").to(dt)
            qo = torch.tensor(off, dtype=torch.int32, device="cuda")
            vl = None if valid is None else torch.tensor(
                valid, dtype=torch.int32, device="cuda")
            plan = OverlapPlanner().plan_ring_attention(
                B, tq, tk, H, KH, D, Dv, dt, n, causal=causal,
                q_sharded=sharded, q_offset=None)
            kw = dict(plan=plan, q_offset=qo, valid_len=vl)
            tag = (f"ring bwd n={n} B{B} tq{tq} tk{tk} H{H}/{KH} D{D}/{Dv} "
                   f"sharded={sharded} causal={causal} {dt}")
            route = _attention_route(torch, dt, D, Dv, H // KH)
            with use_default(ctx):
                o, lse = _counted(fwd, lambda: fwd(q, kk, v, group,
                                                   return_lse=True, **kw),
                                  route)
                _, want_lse = k.fused_ring_attention_plain(
                    q, kk, v, group, return_lse=True, **kw)
                dead = torch.isposinf(want_lse)
                l_err = max_err(torch, torch.where(dead, 0, lse),
                                torch.where(dead, 0, want_lse))
                check(torch.equal(torch.isposinf(lse), dead)
                      and bool(torch.isfinite(lse[~dead]).all())
                      and l_err <= 1e-4, f"{tag}: lse err {l_err}")
                want = k.fused_ring_attention_bwd_plain(q, kk, v, do, group,
                                                        **kw)
                b_route = _ring_bwd_route(torch, dt, D, Dv, H // KH)
                got = _counted(bwd, lambda: bwd(q, kk, v, o, do, lse, group,
                                                **kw), b_route)
                again = bwd(q, kk, v, o, do, lse, group, **kw)
                args = [t.detach().requires_grad_() for t in (q, kk, v)]
                out = fwd(*args, group, **kw)
                auto = torch.autograd.grad(out, args, do)
            check(torch.equal(out, o), f"{tag}: RingAttentionFn's output")
            for name, x, w, y, a in zip(("dq", "dk", "dv"), got, want, again,
                                        auto):
                err = max_err(torch, x, w)
                scale = max(float(w.float().abs().max()), 1e-6)
                check(bool(torch.isfinite(x).all()) and err <= tol * scale,
                      f"{tag} {name} on {b_route}: err {err} (scale {scale})")
                check(torch.equal(x, y) and torch.equal(x, a),
                      f"{tag} {name} on {b_route}: two launches differ")
    before = bwd.launches
    try:
        with use_default(ctx):
            bwd(q, kk, v, o.float(), do, lse, group, **kw)
        check(False, "ring bwd: an f32 output over bf16 operands was not "
              "refused")
    except TypeError:
        pass
    check(bwd.launches == before, "ring bwd: a refused call counted a launch")
    f32 = [t.float() for t in (q, kk, v, o, do)]
    with use_default(ctx):
        _refused_off_rule(ra_mod, bwd, lambda: bwd(
            *f32[:4], f32[4], lse, group, **kw), "ring bwd",
            rule_name="ring_bwd_route")


def check_cp_decode(torch, k, g) -> None:
    """The context-sharded decode's partial on the card: row 5's kernel with
    the lse where a row sees no key (``valid_len`` 0) writes 0 and +inf on
    both routes, as its plain version does (the combine turns that into
    weight 0); then ``cp_decode_attention`` over 4 data ranks, one to three
    of them past ``pos`` and ``pos`` on and across a chunk boundary,
    against its plain version (the reference's einsum form) and against
    the replicated decode's flash call on the same keys; bf16 (1.6e-2 of
    the output's scale) and f32 (2e-5) at D = 64 (the tensor cores in bf16)
    and D = 48 (off the rule: the CUDA cores)."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import layers

    kern = k.flash_attention_kernel
    dev = g.device
    for dt, D in ((torch.bfloat16, 64), (torch.float32, 64),
                  (torch.bfloat16, 48)):
        route = _attention_route(torch, dt, D, D, 1)
        q = torch.randn(2, 1, 1, 4, D, generator=g, device=dev).to(dt)
        kk, v = (torch.randn(2, 1, 96, 4, D, generator=g, device=dev)
                 .to(dt) for _ in range(2))
        vl = torch.tensor([[0], [37]], dtype=torch.int32, device=dev)
        out, lse = _counted(kern, lambda: kern(
            q, kk, v, causal=False, valid_len=vl, return_lse=True), route)
        want, wlse = k.flash_attention_plain(q, kk, v, causal=False,
                                             valid_len=vl, return_lse=True)
        check(not out[0].any() and bool(torch.isposinf(lse[0]).all())
              and bool(torch.isposinf(wlse[0]).all()),
              f"cp partial {dt} D {D} ({route}): a row with no key wrote "
              f"{out[0].abs().max()} and lse {lse[0]}")
        tol = 2e-5 if dt == torch.float32 else 1.6e-2
        check(max_err(torch, out, want) <= tol * float(want.abs().max())
              and max_err(torch, lse[1:], wlse[1:]) <= 1e-4,
              f"cp partial {dt} D {D} ({route}): differs from plain")
    mesh = RankMesh(("data", "model"), (4, 2))
    group = DiompGroup(("data",), name="dp_inner")
    S, s_loc = 256, 64
    for dt, D in ((torch.bfloat16, 64), (torch.float32, 64),
                  (torch.bfloat16, 48)):
        q = torch.randn(4, 2, 2, 1, 8, D, generator=g, device=dev).to(dt)
        q = q[:1].expand(4, 2, 2, 1, 8, D).contiguous()    # replicated
        kg, vg = (torch.randn(2, 2, S, 4, D, generator=g, device=dev)
                  .to(dt) for _ in range(2))               # (model, B, S)
        sh = [c.unflatten(2, (4, s_loc)).movedim(2, 0).contiguous()
              for c in (kg, vg)]                           # (data, model..)
        for pos in (5, 64, 65, 200, S):
            cache = layers.KVCache(*sh, torch.full((4, 2), pos,
                                                   dtype=torch.int32,
                                                   device=dev),
                                   seq_sharded=True)
            with use_default(DiompContext(mesh=mesh, device=dev)):
                got = layers.cp_decode_attention(q, cache, group)
                want = layers.cp_decode_attention_plain(q, cache, group)
            whole = k.flash_attention_plain(
                q[0], kg, vg, causal=False, valid_len=pos)
            tol = 2e-5 if dt == torch.float32 else 1.6e-2
            scale = float(want.float().abs().max())
            check(bool(torch.isfinite(got).all())
                  and max_err(torch, got, want) <= tol * scale
                  and max_err(torch, got[0], whole) <= tol * scale,
                  f"cp_decode_attention {dt} D {D} pos {pos}: err "
                  f"{max_err(torch, got, want)}")


SMALL_CHECKS = {"matmul": check_matmul, "ring": check_ring,
                "leap": check_leap, "fused_step": check_fused_step,
                "flash": check_flash, "flash_bwd": check_flash_bwd,
                "cp_decode": check_cp_decode,
                "expert_mlp": check_expert_mlp,
                "moe_dispatch": check_moe_dispatch,
                "expert_mlp_bwd": check_expert_mlp_bwd,
                "moe_dispatch_bwd": check_moe_dispatch_bwd,
                "linear_scan": check_linear_scan,
                "linear_scan_bwd": check_linear_scan_bwd,
                "ring_attention": check_ring_attention,
                "ring_attention_bwd": check_ring_attention_bwd,
                "minimod": check_minimod}


# -- the serving phase ---------------------------------------------------------


def _sdpa(torch, q, kk, v, visible, causal=True):
    """``scaled_dot_product_attention`` on the flash kernel's operands
    (``(..., B, T, H, D)``, GQA) under a boolean ``(N, Tq, Tk)`` mask or,
    with ``visible`` None, under ``is_causal=True`` (the causal mask from
    position 0, Tq = Tk), or with no mask at all where ``causal`` is
    False: the library yardstick, never called by the port."""
    import torch.nn.functional as F
    q4 = q.reshape(-1, *q.shape[-3:]).transpose(1, 2)
    k4 = kk.reshape(-1, *kk.shape[-3:]).transpose(1, 2).contiguous()
    v4 = v.reshape(-1, *v.shape[-3:]).transpose(1, 2).contiguous()
    kw = (dict(is_causal=causal) if visible is None
          else dict(attn_mask=visible[:, None]))

    def call():
        return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True,
                                              **kw)

    call.backend = None                  # PyTorch's own pick
    if v.shape[-1] == q.shape[-1]:
        return call
    # Dv != D (MLA): the first backend, in PyTorch's order, that takes it
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def pinned(b=b):
            with sdpa_kernel(b):
                return call()
        try:
            with warnings.catch_warnings():  # each refusal says why
                warnings.simplefilter("ignore")
                pinned()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        pinned.backend = b.name
        return pinned
    raise RuntimeError("no SDPA backend takes Dv != D")


def _flash_at(torch, k, name, q, kk, v, q_off, valid, min_blocks=0,
              sample=False, route="wgmma", causal=True):
    """The flash kernel against its plain version and SDPA at one shape of
    the serving path; q_off / valid are ``(*ranks, B)`` int32 tensors.  The
    launch must take ``route`` (the tensor cores unless the caller says
    otherwise) and, where ``min_blocks`` is given (a decode), launch at
    least that many blocks through the key split; ``sample`` samples the
    card's clock and power over the kernel's timing.  Non-causal (the
    audio encoder), every key below ``valid`` is visible, and SDPA runs
    without a mask where every key is valid."""
    Tq, H, D = q.shape[-3:]
    Tk, KH, Dv = kk.shape[-3], kk.shape[-2], v.shape[-1]
    kw = dict(causal=causal, q_offset=q_off, valid_len=valid)
    got = _counted(k.flash_attention_kernel,
                   lambda: k.flash_attention_kernel(q, kk, v, **kw), route)
    grid = dict(k.flash_attention_kernel.last_grid)
    check(grid["blocks"] >= min_blocks,
          f"flash {name}: {grid} launches fewer than {min_blocks} blocks")
    want = k.flash_attention_plain(q, kk, v, **kw)
    err = max_err(torch, got, want)
    # bf16 output: one ulp of the output (2^-7 relative) plus the
    # accumulation order
    check(bool(torch.isfinite(got).all())
          and err <= 1.6e-2 * float(want.float().abs().max()),
          f"flash {name}: err {err}")
    del got, want
    # keys each query row sees: k <= q_offset + t and k < valid_len
    t = torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tk, device=q.device)
    qo, vl = q_off.reshape(-1, 1, 1), valid.reshape(-1, 1, 1)
    visible = (kpos < vl).expand(-1, Tq, Tk)                # (N, Tq, Tk)
    if causal:
        visible = visible & (kpos <= qo + t[:, None])
    pairs = int(visible.sum()) * H                          # (row, key) pairs
    rows_read = int(torch.clamp(valid, max=Tk).sum())
    nbytes = 2 * (q.numel() + rows_read * KH * (D + Dv)
                  + q.numel() // D * Dv)
    ops = 2 * pairs * (D + Dv)
    def call():
        return k.flash_attention_kernel(q, kk, v, **kw)

    ms = cuda_ms(torch, call, 10)
    if sample:
        sampled_ms(torch, call, ms, f"flash {name}")
    # the card's own time in the kernels (the event time above also holds
    # the host's time between launches where that is longer), with the
    # operands warm in L2 and cold
    dev = device_ms(torch, call, 10, FLASH_KERNELS)
    cold = device_ms(torch, call, 10, FLASH_KERNELS, cold_l2=True)
    plain = cuda_ms(torch, lambda: k.flash_attention_plain(q, kk, v, **kw), 3)
    whole = not causal and bool((valid >= Tk).all())
    sdpa = _sdpa(torch, q, kk, v, None if whole else visible, causal=causal)
    library = cuda_ms(torch, sdpa, 10)
    library_dev = device_ms(torch, sdpa, 10, ("",))
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"flash {name}: q {tuple(q.shape)} k {tuple(kk.shape)} v "
        f"{tuple(v.shape)} (keys seen {pairs // H}; {grid}): {ms:.4f} ms "
        f"(device {_ms(dev, 4)}, L2 cold {_ms(cold, 4)}), plain "
        f"{plain:.3f}, sdpa {library:.4f} (device {_ms(library_dev, 4)}; "
        f"backend {sdpa.backend or 'default'}), bound {b_ms:.4f} ms by "
        f"{b_by}, err {err:.4g}")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
           "device_ms": dev, "device_ms_cold_l2": cold,
           "library_device_ms": library_dev,
           "splits": grid["splits"], "blocks": grid["blocks"]}
    if sdpa.backend:
        out["library_backend"] = sdpa.backend
    return out


def _flash_call(torch, k, name, args, kw, route="wgmma"):
    """:func:`_flash_at` on the arguments a layer gave the flash kernel,
    its offsets made per-row tensors as the kernel's wrapper makes them."""
    q, kk, v = args
    check(not kw.get("prefix_len"), f"flash {name}: called with {kw}")
    lead = q.shape[:-3]

    def per_row(x):
        return torch.as_tensor(x, dtype=torch.int32, device=q.device) \
            .expand(lead).contiguous()

    vl = kw.get("valid_len")
    return _flash_at(torch, k, name, q, kk, v, per_row(kw.get("q_offset", 0)),
                     per_row(kk.shape[-3] if vl is None else vl),
                     route=route, causal=kw.get("causal", True))


def _device_events(prof) -> dict:
    """Each kernel's (or copy's) device time in a finished trace, in us by
    name, read from the trace's raw events: only those on the card.  What
    ``key_averages()`` gives for them, without turning every host event of
    the trace into a ``FunctionEvent`` first (about 30 s for a profiled
    training step of tens of thousands of host ops)."""
    out = {}
    for evt in prof.profiler.kineto_results.events():
        if "CUDA" not in str(evt.device_type()) or getattr(
                evt, "is_user_annotation", lambda: False)():
            continue
        us = evt.duration_ns() / 1e3
        out[evt.name()] = out.get(evt.name(), 0.0) + us
    return out


def _breakdown(torch, fn, reps: int = 3) -> str:
    """Device time of ``fn`` by kernel group from ``torch.profiler`` (ms a
    call), and the device's busy share of the wall time of those calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for name, us in _device_events(prof).items():
        if us <= 0:
            continue
        group = ("flash" if any(t in name for t in FLASH_KERNELS) else
                 "flash_bwd" if any(t in name for t in FLASH_BWD_KERNELS)
                 else
                 "stencil" if any(t in name for t in LEAP_KERNELS
                                  + FUSED_KERNELS) else
                 "ring_attention" if "ring_attention" in name else
                 "linear_scan" if any(t in name for t in SCAN_KERNELS) else
                 "linear_scan_bwd" if any(t in name for t in SCAN_BWD_KERNELS)
                 else
                 "expert_mlp_bwd" if any(t in name for t in EXPERT_BWD_KERNELS)
                 else
                 "moe_dispatch_bwd" if any(t in name for t in MOE_BWD_KERNELS)
                 else
                 "moe_dispatch" if any(t in name for t in MOE_KERNELS)
                 else
                 "expert_mlp" if any(t in name for t in EXPERT_KERNELS) else
                 "gemm" if any(t in name.lower() for t in
                               ("gemm", "cutlass", "sm90", "cublas",
                                "nvjet"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3 / reps
        top.append((us / 1e3 / reps, name[:60]))
    busy = sum(groups.values())
    if not busy:
        return "device time not measured (the profiler saw no kernels)"
    top = ", ".join(f"{n} {t:.2f}" for t, n in sorted(top)[::-1][:6])
    parts = ", ".join(f"{g} {t:.2f}" for g, t in sorted(groups.items()))
    return (f"{wall_ms / reps:.2f} ms a call, kernels {busy:.2f} ms "
            f"({parts}); device busy {100 * busy * reps / wall_ms:.1f} %; "
            f"top: {top}")


def _serve_bounds(cfg, schema, lengths, steps_keys, kv_bytes_per_token,
                  steps_experts=None):
    """The least device time (ms, bf16) of each serving metric, from the
    model's shapes: a request's time to first token alone on the card (its
    prompt's matmul and causal-attention flops, or its chunks' weight reads)
    and each decode step whose live slots read ``steps_keys[i]`` keys (the
    weights read once, and those K/V rows; a parked slot's rows are not
    work a user asked for and are not counted).  The embedding table is
    never read whole, unless it is the tied head.  MoE: a token runs k of E
    experts; a decode step reads
    the weights of the experts its tokens route to, ``steps_experts[i]``
    summed over the layers (from the step's own count tables); a prefill
    chunk of c real tokens reads ``min(E, c·k)`` experts a layer, the most
    it can reach (every expert, for a chunk of E/k tokens or more).  MLA:
    the q.k products are D = 192 wide and the p.v products Dv = 128; its
    decompression of K/V from the latent is not counted (the absorbed form
    needs none); the MTP leaves are never read."""
    mm = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router",
          "wq_a", "wq_b", "wkv_a", "wkv_b", "w_gate_s", "w_up_s", "w_down_s")
    # the MTP head is a training loss term: serving reads none of it
    schema = {n: s for n, s in schema.items() if not n.startswith("mtp/")}
    size = {n: math.prod(s.shape) for n, s in schema.items()}
    nbytes = {n: size[n] * (4 if s.dtype == "float32" else 2)
              for n, s in schema.items()}
    layer = sum(v for n, v in size.items() if n.split("/")[-1] in mm)
    tied = "lm_head" not in schema          # the VLM's head is the table
    head = size["embed/table" if tied else "lm_head"]
    experts = [n for n in schema if n.endswith("_e")]
    L, H = cfg.num_layers, cfg.num_heads
    # the q.k and p.v widths (MLA: 192 and 128), and the MoE layers
    D, Dv = cfg.head_dim, cfg.v_head_dim or cfg.head_dim
    Lm = L - cfg.first_k_dense if cfg.moe else L
    E, k = max(cfg.num_experts, 1), cfg.experts_per_token
    dense_bytes = sum(v for n, v in nbytes.items()
                      if (tied or n != "embed/table") and n not in experts)
    expert_bytes = sum(nbytes[n] for n in experts) / (Lm * E)  # one, a layer
    pair_params = sum(size[n] for n in experts) / (Lm * E)     # 3·d·f
    ttft = []
    for n in lengths:
        n = int(n)
        chunks = [min(CHUNK, n - c) for c in range(0, n, CHUNK)]
        ops = (2 * layer * n + L * H * (D + Dv) * n * (n + 1)
               + 2 * head * len(chunks) + 2 * pair_params * n * k * Lm)
        reads = sum(dense_bytes + Lm * min(E, c * k) * expert_bytes
                    for c in chunks) if experts else len(chunks) * dense_bytes
        ttft.append(bound(reads, ops, "bfloat16")[0])
    steps = []
    for i, keys in enumerate(steps_keys):
        routed = steps_experts[i] if experts else 0
        steps.append(bound(
            dense_bytes + routed * expert_bytes
            + kv_bytes_per_token * int(sum(keys)),
            2 * (layer + head) * len(keys)
            + 2 * pair_params * len(keys) * k * Lm, "bfloat16")[0])
    return ttft, steps


def _drive_engine(torch, dev, cfg, mesh, pctx, params, wrappers,
                  on_step=None, chunk_kernel="flash_attention",
                  decode_kernel="flash_attention"):
    """Serve the phase's 8 requests through the port's engine, every
    wrapper's count zeroed just before the run and read just after; each
    decode call is timed with CUDA events (``on_step`` runs after each, off
    the clock).  Checks every request, the decode logits, and that every
    layer of every chunk call ran ``chunk_kernel`` and of every decode
    call ``decode_kernel`` (flash by default; None: no attention kernel,
    as MLA's absorbed decode)."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.core.context import DiompContext
    from repro_torch.serve.engine import ServeEngine

    def engine(c, params, **kw):
        ctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 31,
                           allocator="buddy")
        return ServeEngine(c, mesh, pctx, params, context=ctx,
                           page_tokens=PAGE_TOKENS, **kw)

    rng = np.random.RandomState(0)
    # warm-up: library handles and allocator pools, off the record
    warm = engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                  prefill_chunk=CHUNK)
    warm.submit(rng.randint(0, cfg.vocab_size, 40), max_new=2)
    warm.run()
    del warm

    lengths = rng.randint(MIN_PROMPT, MAX_PROMPT + 1, size=REQUESTS)
    eng = engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                 prefill_chunk=CHUNK)
    step_events, step_keys, finite = [], [], []
    fn = eng.decode_step.fn

    def timed_decode(*args):
        # keys each live slot reads this step: its rows so far, plus one
        step_keys.append([int(eng.host_pos[s]) + 1
                          for s, r in eng.active.items()
                          if r.fed >= len(r.prompt)])
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = fn(*args)
        b.record()
        step_events.append((a, b))
        finite.append(torch.isfinite(logits).all())
        if on_step is not None:
            on_step()
        return logits, cache

    eng.decode_step.fn = timed_decode
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, n), max_new=MAX_NEW)
            for n in lengths]
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wr.launches for name, wr in wrappers.items()}
    routes = _attention_routes(wrappers, f"serve {cfg.name}")
    combine = wrappers["flash_attention"].combine_launches
    eng.decode_step.fn = fn
    log(f"serve {cfg.name}: {REQUESTS} requests (prompts "
        f"{sorted(lengths.tolist())}), {eng.steps} engine steps, "
        f"{eng.device_calls} device calls in {wall:.2f} s; launches "
        f"{launches}")
    for r, n in zip(reqs, lengths):
        check(r.done and len(r.out) == MAX_NEW, f"request of {n} unfinished")
        check(r.prefill_steps == -(-n // CHUNK),
              f"request of {n}: {r.prefill_steps} prefill steps")
        check(all(0 <= t < cfg.vocab_size for t in r.out), "bad token")
    check(bool(torch.stack(finite).all()), "non-finite decode logits")
    chunks = sum(r.prefill_steps for r in reqs)
    want = {"flash_attention": 0, chunk_kernel: 0}
    want[chunk_kernel] += cfg.num_layers * chunks
    if decode_kernel is not None:
        want[decode_kernel] = want.get(decode_kernel, 0) + cfg.num_layers * (
            eng.device_calls - chunks)
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launches {launches[name]} != {n} ({cfg.num_layers} "
              f"layers, {chunks} chunk calls of {eng.device_calls})")
    return SimpleNamespace(
        eng=eng, reqs=reqs, lengths=lengths, launches=launches, rng=rng,
        routes=routes, combine=combine,
        engine=engine, step_keys=step_keys,
        steps_ms=[a.elapsed_time(b) for a, b in step_events])


def _report_serving(torch, dev, cfg, mesh, params, run, steps_experts=None):
    """Time to first token, the decode step, their bounds, and where one
    decode call and one chunk-prefill call spend their time."""
    import numpy as np
    from repro_torch.core.context import use_default
    from repro_torch.interop import stack_shards
    from repro_torch.models import schema as sch

    eng = run.eng
    stats = eng.latency_stats()
    ttft, steps_ms = stats["ttft_s"], run.steps_ms
    if cfg.attention == "mla":
        # MLA's latent row and rope'd key a token a layer, read by every
        # "model" rank (each attends over the whole latent)
        per_token = eng.cache["c"].element_size() * cfg.num_layers \
            * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * mesh.shape["model"]
    else:
        # K/V bytes a token: each kv head once (a cache replicated over
        # "model" is read once in the bound)
        per_token = 2 * eng.cache["k"].element_size() * cfg.num_layers \
            * cfg.kv_heads * cfg.head_dim
    ttft_b, step_b = _serve_bounds(cfg, sch.build_schema(cfg), run.lengths,
                                   run.step_keys, per_token, steps_experts)
    steady, steady_b = steps_ms[2:] or steps_ms, step_b[2:] or step_b
    # a smoke reading, not a tail: 8 requests sent at once onto 4 slots, so
    # most of it is queueing behind earlier prompts
    log(f"serve {cfg.name}: time to first token over {REQUESTS} requests "
        f"sent at once (smoke reading, queueing included): median "
        f"{ttft['p50'] * 1e3:.1f} ms, max {ttft['max'] * 1e3:.1f} ms; decode "
        f"step median {statistics.median(steady):.3f} ms over {len(steady)} "
        f"steps (min {min(steady):.3f}, max {max(steady):.3f}); "
        f"{stats['tokens']} tokens; kv {eng.kv_stats}")
    log(f"serve {cfg.name}: bounds (bf16 at {PEAK_OPS['bfloat16'] / 1e12:.0f}"
        f" TFLOP/s, {PEAK_BYTES / 1e12:.2f} TB/s): time to first token of a "
        f"request alone on the card median {statistics.median(ttft_b):.2f} "
        f"ms, max {max(ttft_b):.2f} ms; decode step at each timed step's "
        f"live positions median {statistics.median(steady_b):.3f} ms (min "
        f"{min(steady_b):.3f}, max {max(steady_b):.3f}); step time over its "
        f"bound median "
        f"{statistics.median(t / b for t, b in zip(steady, steady_b)):.2f}")

    # where a decode step and a chunk-prefill call spend their time: the
    # engine's own steps on its cache, at mid-length positions
    pos = (MAX_LEN * np.array([2, 3, 4, 5]) // 8).astype(np.int32)
    eng._set_pos(pos)
    dtoks = stack_shards(run.rng.randint(0, cfg.vocab_size, (SLOTS, 1)), mesh,
                         eng.decode_step.token_spec, device=dev,
                         dtype=torch.int64)

    def decode_once():
        eng.cache["pos"] = stack_shards(pos, mesh, eng._specs["pos"],
                                        device=dev)
        with use_default(eng.dctx):
            eng.decode_step(params, dtoks, eng.cache)

    ctoks = stack_shards(run.rng.randint(0, cfg.vocab_size, (1, CHUNK)), mesh,
                         eng.chunk_step.token_spec, device=dev,
                         dtype=torch.int64)
    eng.host_pos[0] = MAX_LEN // 2

    def chunk_once():
        with use_default(eng.dctx):
            eng.chunk_step(params, ctoks, eng._slot_cache(0), CHUNK)

    log(f"serve {cfg.name}: decode step at positions {pos.tolist()}: "
        f"{_breakdown(torch, decode_once)}")
    log(f"serve {cfg.name}: chunk prefill of {CHUNK} at position "
        f"{MAX_LEN // 2}: {_breakdown(torch, chunk_once)}")
    return decode_once


def serve_phase(torch, k, dev, wrappers) -> dict:
    """Serve glm4-9b at full width through the port's engine; returns the
    flash kernel's line of the ``kernels`` JSON."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx

    cfg = configs.get(SERVE_ARCH)
    mesh = make_smoke_mesh(SERVE_RANKS)
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"serve: {cfg.name} on {mesh.shape}, {nbytes / 1e9:.2f} GB of "
        f"random bf16 weights in {time.perf_counter() - t0:.1f} s")
    run = _drive_engine(torch, dev, cfg, mesh, pctx, params, wrappers)
    _report_serving(torch, dev, cfg, mesh, params, run)
    eng, reqs, nd = run.eng, run.reqs, mesh.ndim

    # the flash kernel at the path's two shapes, on the served cache
    g = torch.Generator(device=dev).manual_seed(5)
    H, hd = cfg.num_heads // mesh.shape["model"], cfg.head_dim
    ends = [len(r.prompt) + r.max_new - 1 for r in reqs[-SLOTS:]]
    pos = torch.tensor(ends, dtype=torch.int32, device=dev).expand(
        *mesh.sizes, SLOTS).contiguous()
    q = torch.randn(*mesh.sizes, SLOTS, 1, H, hd, generator=g,
                    device=dev).to(torch.bfloat16)
    kc, vc = eng.cache["k"].select(nd, 0), eng.cache["v"].select(nd, 0)
    line = {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:125",
            "launches": run.launches["flash_attention"], "shape": "decode",
            "route_launches": run.routes["flash_attention"],
            "combine_launches": run.combine}
    line.update(_flash_at(torch, k, "decode", q, kc, vc, pos, pos + 1,
                          min_blocks=132))
    q = torch.randn(*mesh.sizes, 1, CHUNK, H, hd, generator=g,
                    device=dev).to(torch.bfloat16)
    p0 = torch.full((*mesh.sizes, 1), MAX_LEN - CHUNK, dtype=torch.int32,
                    device=dev)
    line["chunk"] = _flash_at(torch, k, "chunk", q, kc[..., :1, :, :, :],
                              vc[..., :1, :, :, :], p0, p0 + CHUNK,
                              sample=True)
    del eng, q, kc, vc
    run.eng = None
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve: peak device memory {peak:.1f} GB")
    # rank death on the same weights: undisturbed, graceful, abrupt
    t0 = time.perf_counter()
    rank_death_runs(torch, dev, cfg, mesh, pctx, params, wrappers)
    log(f"rank death: three runs in {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # chunked prefill == token by token (greedy), at full width with the
    # depth cut to 2 layers and float32 weights: a 512-row and a 1-row GEMM
    # round bf16 at other places, enough to flip a near-tied argmax over
    # 151552 logits; in float32 the two orders agree to about 1e-6
    import dataclasses
    small = dataclasses.replace(cfg, num_layers=2)
    params = sch.init_params(small, mesh, torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
    params = {n: p.float() for n, p in params.items()}
    prompts = [run.rng.randint(0, cfg.vocab_size, n) for n in (5, 37, 70)]
    outs = {}
    for chunk in (1, 32):
        e = run.engine(small, params, slots=SLOTS, max_len=128,
                       prefill_chunk=chunk)
        # the engine's cache is bf16, as the reference's; this check keeps
        # it in the weights' float32, since the flash kernel takes one dtype
        e.cache = {n: c if n == "pos" else c.float()
                   for n, c in e.cache.items()}
        rs = [e.submit(p, max_new=8) for p in prompts]
        e.run()
        outs[chunk] = [r.out for r in rs]
    check(outs[1] == outs[32], f"chunked != token by token: {outs}")
    log(f"serve: chunked prefill (32) == token by token over 3 prompts, "
        f"{sum(map(len, outs[1]))} greedy tokens")
    del params
    torch.cuda.empty_cache()
    return line


class _Tap:
    """Route ``module.name`` through a recorder: ``keep(args, kw)`` decides
    whether a call's arguments are kept in ``calls``; the original runs
    either way (its launch counts included).  The recorder is made on
    entry and dropped on exit, so nothing but ``calls`` outlives the block
    (no reference cycle keeps the arguments alive)."""

    def __init__(self, module, name, keep):
        # keep(args, kw) -> bool
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def tapped(*args, **kw):
            if self.keep(args, kw):
                self.calls.append((args, kw))
            return self.orig(*args, **kw)

        # a wrapper counts its launches on the function its module's name
        # holds: the recorder shares the original's counters
        tapped.__dict__ = self.orig.__dict__
        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _Swap:
    """``module.name`` replaced by ``fn`` while the block runs."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _dispatch_at(torch, k, name, args, kw, plan, with_mlp=True,
                 plain_experts=0):
    """The fused dispatch kernel at one shape of the serving path (the
    arguments a MoE layer gave it): equal to the emulation through the
    expert-MLP kernel, within tolerance of the plain version, timed (CUDA
    events of back-to-back calls, and the kernel's device time from the
    profiler, warm and with L2 flushed).  Then, ``with_mlp``, the
    expert-MLP kernel on the same landed blocks (every rank's blocks from
    every source in one call, the a2a layout), held against its plain
    version and timed the same way; with ``plain_experts`` the plain
    version runs that many experts at a time (at deepseek-v3's widths it
    lifts every expert's weights to f32 over every source).  Returns the
    dispatch's numbers and the expert MLP's (None without it)."""
    from repro_torch.kernels.moe_dispatch.fused import dispatch_buffers
    got, dropped = k.fused_moe_dispatch_kernel(*args, **kw)
    emu, _ = k.fused_moe_dispatch_interpret(*args, **kw, mlp=k.expert_mlp)
    plain, _ = k.fused_moe_dispatch_plain(*args, **kw)
    check(torch.equal(got, emu), f"moe_dispatch {name}: differs from the "
          "emulation through the expert-MLP kernel")
    err = max_err(torch, got, plain)
    # bf16 output: one ulp of the output and of the rounded h, plus order
    check(bool(torch.isfinite(got).all()) and not dropped.any()
          and err <= 1.6e-2 * float(plain.float().abs().max()),
          f"moe_dispatch {name}: err {err}, dropped {dropped.tolist()}")
    del emu, plain
    toks, top_e, top_w, wg, wu, wd = args[:6]
    buf, _, _, _, counts = dispatch_buffers(toks, top_e, top_w, plan)
    # the work these inputs need: every kept (token, choice) pair's three
    # products; the weights of every expert some row reaches, read once;
    # the tokens read and the combined rows written once
    pairs = int(counts.sum())
    routed = int((counts.reshape(-1, plan.E).sum(0) > 0).sum())
    d, f = wg.shape[-2:]
    nbytes = 2 * (routed * 3 * d * f + 2 * toks.numel()) \
        + 4 * top_w.numel() + 8 * top_e.numel()
    ops = 2 * 3 * d * f * pairs
    call = lambda: k.fused_moe_dispatch_kernel(*args, **kw)  # noqa: E731
    ms = cuda_ms(torch, call, 5)
    dev_ms = device_ms(torch, call, 5, MOE_KERNELS)
    cold_ms = device_ms(torch, call, 5, MOE_KERNELS, cold_l2=True)
    plain = cuda_ms(torch, lambda: k.fused_moe_dispatch_plain(*args, **kw), 2)
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"moe_dispatch {name}: toks {tuple(toks.shape)}, {pairs} pairs on "
        f"{routed} experts, cap_pad {plan.cap_pad}: {ms:.3f} ms, device "
        f"{_ms(dev_ms, 4)} warm / {_ms(cold_ms, 4)} L2 flushed, plain "
        f"{plain:.3f}, "
        f"bound {b_ms:.4f} ms by {b_by}, err {err:.4g}")
    disp = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_l2_flushed": cold_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if not with_mlp:
        return disp, None
    # the expert MLP on the landed blocks: x (dst, src, E_loc, C, d), each
    # rank's weights shared by its sources (one ring: the mesh is the EP
    # group)
    ep = plan.ep
    check(toks.shape[:-2].numel() == ep, f"{name}: more than one ring")
    x = buf.reshape(ep, *buf.shape[-4:]).transpose(0, 1).contiguous()
    live = counts.reshape(ep, ep, -1).transpose(0, 1).contiguous()
    wg, wu, wd = (w.reshape(ep, *w.shape[-3:]) for w in (wg, wu, wd))
    mlp = lambda: k.expert_mlp(x, wg, wu, wd, live)  # noqa: E731
    got = _counted(k.expert_mlp, mlp, "wgmma")
    E_loc = x.shape[2]
    step_e = plain_experts or E_loc
    mlp_err = scale = 0.0
    for e0 in range(0, E_loc, step_e):
        sl = slice(e0, e0 + step_e)
        want = k.expert_mlp_plain(x[:, :, sl].contiguous(), wg[:, sl],
                                  wu[:, sl], wd[:, sl], live[:, :, sl])
        mlp_err = max(mlp_err, max_err(torch, got[:, :, sl], want))
        scale = max(scale, float(want.float().abs().max()))
        del want
    dead = ~(torch.arange(x.shape[-2], device=x.device) < live[..., None])
    check(mlp_err <= 1.6e-2 * scale and not got[dead].any(),
          f"expert_mlp {name}: err {mlp_err}")
    reached = int((live.sum(-2) > 0).sum())      # (rank, expert) pairs
    mlp_bytes = 2 * (reached * 3 * d * f + 2 * pairs * d) + 4 * live.numel()
    mb_ms, mb_by = bound(mlp_bytes, ops, "bfloat16")
    mlp_ms = cuda_ms(torch, mlp, 5)
    mlp_dev = device_ms(torch, mlp, 5, EXPERT_KERNELS)
    mlp_cold = device_ms(torch, mlp, 5, EXPERT_KERNELS, cold_l2=True)
    log(f"expert_mlp {name} blocks: x {tuple(x.shape)}, {pairs} live rows on "
        f"{reached} experts: {mlp_ms:.3f} ms, device {_ms(mlp_dev, 4)} warm / "
        f"{_ms(mlp_cold, 4)} L2 flushed, bound {mb_ms:.4f} ms by {mb_by}, err "
        f"{mlp_err:.4g}")
    shape = list(x.shape)
    del x, live, got
    return disp, {"max_abs_err": mlp_err, "ms": mlp_ms, "device_ms": mlp_dev,
                  "device_ms_l2_flushed": mlp_cold, "bound_ms": mb_ms,
                  "bound_by": mb_by, "shape": shape,
                  "live_rows": pairs, "experts_reached": reached}


def moe_phase(torch, k, dev, wrappers) -> list:
    """Serve qwen3-moe-235b-a22b at full width (depth cut to MOE_LAYERS)
    through the port's engine under ``dispatch_impl="fused"``, then one
    prefill chunk under the default ``"a2a"``; returns the expert-MLP and
    fused-dispatch kernels' lines of the ``kernels`` JSON."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.interop import local_shape, stack_shards
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.fused import dispatch_buffers
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api, layers
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve.step import build_chunk_prefill_step

    cfg = dataclasses.replace(configs.get(MOE_ARCH), num_layers=MOE_LAYERS)
    mesh = make_smoke_mesh(SERVE_RANKS)
    ep, E, kk, d = mesh.shape["model"], cfg.num_experts, \
        cfg.experts_per_token, cfg.d_model
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                 dispatch_impl="fused")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"moe: {cfg.name} at {cfg.num_layers} of 94 layers on {mesh.shape} "
        f"(EP = TP = {ep}, {E // ep} experts a rank), {nbytes / 1e9:.2f} GB "
        f"of random weights in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    plans = {}
    for name, t_loc in (("decode", SLOTS // ep), ("chunk", CHUNK // ep)):
        plans[name] = OverlapPlanner().plan_alltoall(t_loc, d, kk, E, ep,
                                                     torch.bfloat16)
        p = plans[name]
        log(f"moe: {name} plan: t_loc {t_loc}, slots {p.slots}, overlap "
            f"{p.overlap}, cap_pad {p.cap_pad}, block {p.block_bytes} B")
        check(p.overlap, f"moe: the {name} plan fell back to no overlap")

    # every decode call's dispatch arguments (small at decode) and the first
    # chunk call's, for the bounds and the kernel timings below
    steps_calls, chunk_call = [], []

    def keep(args, kw):
        if args[0].shape[-2] <= SLOTS // ep:
            return True
        if not chunk_call:
            chunk_call.append((args, kw))
        return False

    def on_step():
        # a decode call runs every layer's dispatch once (the warm-up
        # engine's decode passed through the tap too)
        steps_calls.append(tap.calls[-cfg.num_layers:])
        tap.calls.clear()

    with _Tap(moe_ops, "fused_moe_dispatch_kernel", keep) as tap:
        run = _drive_engine(torch, dev, cfg, mesh, pctx, params, wrappers,
                            on_step=on_step)
        moe_routes = dict(wrappers["fused_moe_dispatch"].route_launches)
    moe_launches = run.launches["fused_moe_dispatch"]
    check(moe_launches == cfg.num_layers * run.eng.device_calls,
          f"moe dispatch launches {moe_launches} != {cfg.num_layers} x "
          f"{run.eng.device_calls} device calls")
    log(f"moe: dispatch routes {moe_routes}")
    check(moe_routes["simt"] == 0 and moe_routes["wgmma"] == moe_launches,
          f"moe: a served dispatch launch left the tensor cores: {moe_routes}")
    # the experts each timed decode step's tokens reached, summed over its
    # layers, from the steps' own count tables (read here, off the clock)
    steps_experts = []
    for calls in steps_calls:
        n = 0
        for args, kw in calls:
            counts = dispatch_buffers(*args[:3], kw["plan"])[4]
            n += int((counts.reshape(-1, E).sum(0) > 0).sum())
        steps_experts.append(n)
    log(f"moe: experts reached a decode step (over {cfg.num_layers} layers): "
        f"median {statistics.median(steps_experts)}, min "
        f"{min(steps_experts)}, max {max(steps_experts)}")
    decode_once = _report_serving(torch, dev, cfg, mesh, params, run,
                                  steps_experts)
    with run.eng.dctx.dispatch_stats.collect() as ds:
        decode_once()
    dropped = float(ds["moe_dropped"].sum())
    routed = float(ds["moe_routed"].sum())
    check(dropped == 0 and routed == cfg.num_layers * SLOTS * kk,
          f"moe: a decode call dropped {dropped} of {routed} choices")
    log(f"moe: one decode call under a dispatch_stats frame: dropped "
        f"{dropped:.0f} of {routed:.0f} (token, choice) pairs")

    line = {"name": "fused_moe_dispatch", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_dispatch.cu",
            "replaces": "src/repro/kernels/moe_dispatch/fused.py:284",
            "launches": moe_launches, "route_launches": moe_routes,
            "shape": "decode"}
    with use_default(DiompContext(mesh=mesh, device=dev)):
        args, kw = steps_calls[-1][-1]
        disp, mlp_decode = _dispatch_at(torch, k, "decode", args, kw,
                                        kw["plan"])
        line.update(disp)
        args, kw = chunk_call[0]
        line["chunk"], mlp_chunk = _dispatch_at(torch, k, "chunk", args, kw,
                                                kw["plan"])
        # row 8 under chaos at the chunk's shape: the kernel route's puts
        # logged, rolled and retried before the launch
        _chaos_path(torch, "moe_dispatch chunk", wrappers,
                    ["fused_moe_dispatch"], _in_context(
                        mesh, dev, lambda: k.fused_moe_dispatch_kernel(
                            *args, **kw)))
    del run, chunk_call, steps_calls, args, kw, decode_once
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"moe: peak device memory {peak:.1f} GB")

    # one prefill chunk at full width under the default dispatch ("a2a"):
    # its grouped GEMMs run the expert-MLP kernel
    a2a = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    step = build_chunk_prefill_step(cfg, mesh, a2a, C=CHUNK, S_cache=MAX_LEN)
    structs, specs = api.cache_structs(cfg, mesh, a2a, 1, MAX_LEN)
    cache = {n: torch.zeros(local_shape(st.shape, mesh, specs[n]),
                            dtype=st.dtype, device=dev)
             for n, st in structs.items()}
    rng = np.random.RandomState(1)
    toks = stack_shards(rng.randint(0, cfg.vocab_size, (1, CHUNK)), mesh,
                        step.token_spec, device=dev, dtype=torch.int64)
    a2a_ctx = DiompContext(mesh=mesh, device=dev)
    with _Tap(layers, "expert_mlp", lambda a, kw: True) as mlp_tap, \
            use_default(a2a_ctx), a2a_ctx.dispatch_stats.collect() as ds:
        _zero_counts(wrappers)
        logits, _ = step(params, toks, cache, CHUNK)
        torch.cuda.synchronize()
        launches = {name: wr.launches for name, wr in wrappers.items()}
        mlp_routes = dict(wrappers["expert_mlp"].route_launches)
        _attention_routes(wrappers, "moe a2a chunk")
    log(f"moe: expert-MLP routes {mlp_routes}")
    check(mlp_routes["simt"] == 0
          and mlp_routes["wgmma"] == launches["expert_mlp"],
          f"moe a2a chunk: an expert-MLP launch left the tensor cores: "
          f"{mlp_routes}")
    log(f"moe: one a2a prefill chunk of {CHUNK}: launches {launches}; the "
        f"capacity path dropped {float(ds['moe_dropped'].sum()):.0f} of "
        f"{float(ds['moe_routed'].sum()):.0f} (token, choice) pairs over "
        f"{cfg.num_layers} layers")
    check(launches["expert_mlp"] == cfg.num_layers
          and launches["flash_attention"] == cfg.num_layers
          and launches["fused_moe_dispatch"] == 0,
          f"moe a2a chunk: launches {launches}")
    check(bool(torch.isfinite(logits).all()), "moe a2a chunk: bad logits")
    mlp_line = {"name": "expert_mlp", "route": "cuda",
                "source": "src/repro_torch/csrc/expert_mlp.cu",
                "replaces": "src/repro/kernels/moe_dispatch/kernel.py:44",
                "launches": launches["expert_mlp"],
                "route_launches": mlp_routes, "shape": "a2a chunk"}
    mlp_line.update(_expert_mlp_at(torch, k, "a2a chunk",
                                   *mlp_tap.calls[0][0]))
    mlp_line.update({"dispatch_decode_blocks": mlp_decode,
                     "dispatch_chunk_blocks": mlp_chunk})
    del mlp_tap, cache, params
    torch.cuda.empty_cache()
    return [mlp_line, line]


def _expert_mlp_at(torch, k, tag, x, wg, wu, wd, live) -> dict:
    """Row 7 at one call of a path (its landed blocks ``x (*lead, sources,
    E, C, d)`` and live rows ``live``) against its plain version, timed by
    CUDA events and by its device time (warm and with L2 flushed), beside
    its bound: the weights of every (rank, expert) some row reaches read
    once, each live row read and written once; 6 d f operations a live
    row."""
    got, want = k.expert_mlp(x, wg, wu, wd, live), \
        k.expert_mlp_plain(x, wg, wu, wd, live)
    err = max_err(torch, got, want)
    dead = ~(torch.arange(x.shape[-2], device=x.device) < live[..., None])
    check(err <= 1.6e-2 * float(want.float().abs().max())
          and not got[dead].any(), f"expert_mlp {tag}: err {err}")
    del got, want
    torch.cuda.empty_cache()
    pairs = int(live.sum())
    reached = int((live.sum(-2) > 0).sum())      # (rank, expert) pairs
    d, f = wg.shape[-2:]
    nbytes = 2 * (reached * 3 * d * f + 2 * pairs * d) + 4 * live.numel()
    mlp = lambda: k.expert_mlp(x, wg, wu, wd, live)  # noqa: E731
    ms = cuda_ms(torch, mlp, 5)
    dev_ms = device_ms(torch, mlp, 5, EXPERT_KERNELS)
    cold_ms = device_ms(torch, mlp, 5, EXPERT_KERNELS, cold_l2=True)
    plain = cuda_ms(torch, lambda: k.expert_mlp_plain(x, wg, wu, wd, live), 2)
    b_ms, b_by = bound(nbytes, 2 * 3 * d * f * pairs, "bfloat16")
    log(f"expert_mlp {tag}: x {tuple(x.shape)}, {pairs} live rows on "
        f"{reached} experts: {ms:.3f} ms, device {_ms(dev_ms, 4)} warm / "
        f"{_ms(cold_ms, 4)} L2 flushed, plain {plain:.3f}, bound "
        f"{b_ms:.4f} ms by {b_by}, err {err:.4g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_l2_flushed": cold_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "blocks": list(x.shape), "live_rows": pairs,
            "experts_reached": reached}


# -- expert2d serving: qwen3-moe's experts over model x data -----------------

# qwen3-moe-235b-a22b at full width, depth cut to MOE_E2D_LAYERS, on data 2
# x model 2 (EP = 4 under expert2d: 32 whole experts a rank): glm4-9b's 8
# requests onto SLOTS slots under the default layout and under expert2d
# (decodes of 2 slots a data rank: the a2a regime), then
# MOE_E2D_SHORT_PROMPTS on 2 slots under expert2d (one a data rank: the
# replicated regime, its tokens all-gathered over "data"), MOE_E2D_SHORT_NEW
# tokens each; the tokens of both layouts compared greedy on an f32 cut at
# the same depth and width (MOE_E2D_F32_PROMPTS, MOE_E2D_F32_NEW tokens, on
# 4 and on 2 slots)
MOE_E2D_LAYERS, MOE_E2D_MESH = 4, (("data", "model"), (2, 2))
MOE_E2D_SHORT_PROMPTS, MOE_E2D_SHORT_NEW = (300, 700), 16
MOE_E2D_F32_PROMPTS, MOE_E2D_F32_NEW = (5, 37, 70), 8


def _moe_regimes(sizes):
    """A tap of the model stack's ``moe_block``: each call's tokens a rank
    (B_loc x T) appended to ``sizes``, no call kept."""
    from repro_torch.models import transformer as tf_mod

    def keep(args, kw):
        x = args[0]
        nd = x.dim() - 3
        sizes.append(x.shape[nd] * x.shape[nd + 1])
        return False
    return _Tap(tf_mod, "moe_block", keep)


def _served_moe(wrappers, cfg, calls, tag):
    """Every MoE layer of every device call on row 7 (``wgmma``), none on
    row 8; returns the counts."""
    launches = {n: w.launches for n, w in wrappers.items()}
    routes = dict(wrappers["expert_mlp"].route_launches)
    check(launches["expert_mlp"] == cfg.num_layers * calls
          and launches["fused_moe_dispatch"] == 0
          and routes == {"simt": 0, "wgmma": launches["expert_mlp"]},
          f"{tag}: expert-MLP launches {launches['expert_mlp']} (routes "
          f"{routes}) for {cfg.num_layers} layers x {calls} device calls, "
          f"dispatch launches {launches['fused_moe_dispatch']}")
    return {"expert_mlp": launches["expert_mlp"], "routes": routes}


def moe_expert2d_serve_phase(torch, k, dev, wrappers) -> dict:
    """qwen3-moe served under expert2d at full width (MOE_E2D_LAYERS of 94
    layers) on data 2 x model 2, beside the default layout at the same cut,
    every wrapper's count zeroed just before each run and read just after:
    every MoE layer of every chunk and decode call on row 7 on the tensor
    cores, no dispatch kernel (the a2a and replicated regimes run the
    expert MLP on the landed blocks); time to first token and the decode
    step of both layouts; one expert2d decode and chunk call profiled by
    kernel group, and a decode call's drops; then 2 slots under expert2d
    (the replicated regime at decode, asserted from the tokens a rank that
    reach ``moe_block``); then the greedy tokens of both layouts on an f32
    cut, equal, on 4 and on 2 slots."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(MOE_ARCH), num_layers=MOE_E2D_LAYERS)
    mesh = RankMesh(*MOE_E2D_MESH)
    out = {"layers": cfg.num_layers, "mesh": dict(mesh.shape)}

    def params_of(pctx, dtype=None):
        p = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                            .manual_seed(0), device=dev,
                            rules=rules_for_ctx(pctx))
        if dtype is not None:           # leaf by leaf: one copy at a time
            p = {n: p.pop(n).to(dtype) for n in sorted(p)}
        return p

    # the two layouts' weights (the same values) side by side, served in
    # turns: default, expert2d, expert2d, default
    pctxs = {name: ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                         expert2d=name == "expert2d")
             for name in ("default", "expert2d")}
    weights = {name: params_of(pctx) for name, pctx in pctxs.items()}
    for name in ("default", "expert2d"):
        out[name] = {"runs": []}
    for turn, name in enumerate(("default", "expert2d", "expert2d",
                                 "default")):
        tag = f"serve {cfg.name} ({name}, {cfg.num_layers} layers)"
        pctx, params = pctxs[name], weights[name]
        torch.cuda.reset_peak_memory_stats()
        sizes, pending, steps_experts = [], [], []

        def route(toks, router, kk, _orig=layers_mod.route_topk):
            top_w, top_e = _orig(toks, router, kk)
            if toks.shape[-2] <= SLOTS:          # a decode call's layer
                pending.append(top_e)
            return top_w, top_e

        def on_step():
            # the experts each decode step's tokens reach (their owners
            # read them once), summed over its layers, off the clock
            steps_experts.append(sum(int(t.unique().numel())
                                     for t in pending[-cfg.num_layers:]))
            pending.clear()

        with _moe_regimes(sizes), \
                _Swap(layers_mod, "route_topk", route):
            run = _drive_engine(torch, dev, cfg, mesh, pctx, params,
                                wrappers, on_step=on_step)
        res = _served_moe(wrappers, cfg, run.eng.device_calls, tag)
        stats = run.eng.latency_stats()
        steady = run.steps_ms[2:] or run.steps_ms
        res.update({"ttft_ms": {q: stats["ttft_s"][q] * 1e3
                                for q in ("p50", "max")},
                    "decode_ms": {"median": statistics.median(steady),
                                  "min": min(steady), "max": max(steady),
                                  "steps": len(steady)},
                    "device_calls": run.eng.device_calls,
                    "experts_a_decode_step": statistics.median(
                        steps_experts),
                    "tokens_a_rank_at_moe": sorted(set(sizes))})
        if name == "expert2d":
            # the decodes: SLOTS // 2 tokens a data rank, 1 a model rank
            # (the a2a regime)
            check(SLOTS // mesh.shape["data"] in sizes,
                  f"{tag}: no decode reached moe_block with "
                  f"{SLOTS // mesh.shape['data']} tokens a rank: {sizes}")
        if turn == 2:
            decode_once = _report_serving(torch, dev, cfg, mesh, params, run,
                                          steps_experts)
            with run.eng.dctx.dispatch_stats.collect() as ds:
                decode_once()
            res["decode_dropped"] = float(ds["moe_dropped"].sum())
            res["decode_routed"] = float(ds["moe_routed"].sum())
            del decode_once
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"{tag}, turn {turn}: " + json.dumps(res))
        out[name]["runs"].append(res)
        del run
    del weights["default"]
    params = weights.pop("expert2d")
    torch.cuda.empty_cache()
    for name in ("default", "expert2d"):
        runs = out[name]["runs"]
        out[name]["expert_mlp"] = sum(r["expert_mlp"] for r in runs)
        out[name]["ttft_ms_p50"] = [r["ttft_ms"]["p50"] for r in runs]
        out[name]["decode_ms_median"] = [r["decode_ms"]["median"]
                                         for r in runs]
    d, e = out["default"], out["expert2d"]
    log(f"serve {cfg.name}: expert2d against the default layout, in turns "
        f"(default, expert2d, expert2d, default): time to first token "
        f"medians {e['ttft_ms_p50']} ms against {d['ttft_ms_p50']}, decode "
        f"step medians {e['decode_ms_median']} ms against "
        f"{d['decode_ms_median']}")

    # 2 slots under expert2d: one decode token a data rank, the replicated
    # regime (every rank of the four dispatches the gathered tokens)
    tag = f"serve {cfg.name} (expert2d, 2 slots)"
    pctx = pctxs["expert2d"]
    eng = ServeEngine(cfg, mesh, pctx, params, context=DiompContext(
        mesh=mesh, device=dev, segment_bytes=1 << 31, allocator="buddy"),
        slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
        page_tokens=PAGE_TOKENS)
    rng = np.random.RandomState(3)
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, n),
                       max_new=MOE_E2D_SHORT_NEW)
            for n in MOE_E2D_SHORT_PROMPTS]
    sizes = []
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    with _moe_regimes(sizes), \
            eng.dctx.dispatch_stats.collect() as ds:
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.out) == MOE_E2D_SHORT_NEW for r in reqs),
          f"{tag}: a request unfinished")
    res = _served_moe(wrappers, cfg, eng.device_calls, tag)
    check(1 in sizes, f"{tag}: no decode took the replicated regime "
          f"(tokens a rank at moe_block {sorted(set(sizes))})")
    ep = pctx.ep_group.descriptor()
    logged = eng.dctx.stats().get(ep, {})
    check(logged.get("allreduce", 0) > 0 and logged.get("alltoall", 0) > 0,
          f"{tag}: the EP group's logged verbs {logged}")
    res.update({"wall_s": wall, "device_calls": eng.device_calls,
                "tokens_a_rank_at_moe": sorted(set(sizes)),
                "ep_group_verbs": logged,
                "dropped": float(ds["moe_dropped"].sum()),
                "routed": float(ds["moe_routed"].sum()),
                "ttft_ms": eng.latency_stats()["ttft_s"]["p50"] * 1e3})
    log(f"{tag}: " + json.dumps(res))
    out["expert2d_2slots"] = res
    del eng, reqs, params
    torch.cuda.empty_cache()

    # the greedy tokens of both layouts on an f32 cut at the same depth
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in MOE_E2D_F32_PROMPTS]
    toks = {}
    for e2d, pctx in zip((False, True), pctxs.values()):
        params = params_of(pctx, torch.float32)
        for slots in (SLOTS, 2):
            eng = ServeEngine(cfg, mesh, pctx, params, context=DiompContext(
                mesh=mesh, device=dev, segment_bytes=1 << 31,
                allocator="buddy"), slots=slots, max_len=128,
                prefill_chunk=32, page_tokens=PAGE_TOKENS)
            eng.cache = {n: c if n == "pos" else c.float()
                         for n, c in eng.cache.items()}
            rs = [eng.submit(p, max_new=MOE_E2D_F32_NEW) for p in prompts]
            eng.run()
            check(all(r.done for r in rs), "f32 cut: a request unfinished")
            toks[(e2d, slots)] = [list(r.out) for r in rs]
            del eng, rs
        del params
        torch.cuda.empty_cache()
    for slots in (SLOTS, 2):
        check(toks[(True, slots)] == toks[(False, slots)],
              f"serve {cfg.name}: expert2d's greedy tokens on the f32 cut "
              f"({slots} slots) differ from the default layout's: "
              f"{toks[(True, slots)]} against {toks[(False, slots)]}")
    out["f32_tokens"] = {"prompts": list(MOE_E2D_F32_PROMPTS),
                         "new": MOE_E2D_F32_NEW,
                         "equal_on_slots": [SLOTS, 2],
                         "tokens": toks[(True, SLOTS)]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serve {cfg.name}: expert2d's greedy tokens on the f32 cut equal "
        f"the default layout's on {SLOTS} and 2 slots "
        f"({sum(map(len, toks[(True, SLOTS)]))} tokens a run); the phase "
        f"took {out['seconds']:.1f} s")
    return out


# -- MLA (deepseek-v3) and the dense GQA configs at full width -------------


def _experts_reached(calls, E: int) -> int:
    """The experts some token reaches in each of the dispatch ``calls``
    (one decode step's layers), summed over the calls."""
    from repro_torch.kernels.moe_dispatch.fused import dispatch_buffers
    n = 0
    for args, kw in calls:
        counts = dispatch_buffers(*args[:3], kw["plan"])[4]
        n += int((counts.reshape(-1, E).sum(0) > 0).sum())
    return n


def mla_phase(torch, k, dev, wrappers) -> dict:
    """Serve deepseek-v3-671b at full width (its 3 leading dense layers and
    MLA_LAYERS - 3 MoE layers) through the port's engine under
    ``dispatch_impl="fused"``, glm4-9b's mesh and traffic: every chunk's MLA
    attention runs flash at D = 192, Dv = 128, G = 1 on the tensor cores,
    every decode step's runs the absorbed form (f32 einsums, no kernel),
    every MoE layer the fused dispatch.  Then flash and the ring kernel at
    the MLA chunk shape, the dispatch at the served shapes, and chunked
    prefill == token by token on an f32 cut.  Returns the flash and
    dispatch entries and the phase's launches for the ``kernels`` line."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh, make_smoke_mesh
    from repro_torch.models import layers
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx

    full = configs.get(MLA_ARCH)
    cfg = dataclasses.replace(full, num_layers=MLA_LAYERS)
    mesh = make_smoke_mesh(SERVE_RANKS)
    tp, kd = mesh.shape["model"], cfg.first_k_dense
    Lm = cfg.num_layers - kd
    E, kk, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    H = cfg.num_heads // tp
    D, Dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                 dispatch_impl="fused")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"mla: {cfg.name} at {kd} dense + {Lm} MoE of {full.num_layers} "
        f"layers on {mesh.shape} ({H} heads and {E // tp} experts a rank, "
        f"latent {cfg.kv_lora_rank} + {cfg.qk_rope_head_dim}), "
        f"{nbytes / 1e9:.2f} GB of random weights (MTP leaves included) in "
        f"{time.perf_counter() - t0:.1f} s, peak of the draw "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()      # serving's own peak below
    for name, t_loc in (("decode", SLOTS // tp), ("chunk", CHUNK // tp)):
        p = OverlapPlanner().plan_alltoall(t_loc, d, kk, E, tp,
                                           torch.bfloat16)
        log(f"mla: {name} dispatch plan: t_loc {t_loc}, slots {p.slots}, "
            f"overlap {p.overlap}, cap_pad {p.cap_pad}, block "
            f"{p.block_bytes} B")
        check(p.overlap, f"mla: the {name} plan fell back to no overlap")

    # every decode call's dispatch arguments and the first chunk call's (as
    # in moe_phase), and the (D, Dv, G) of every flash call the layers make
    steps_calls, chunk_call, shapes = [], [], set()

    def keep(args, kw):
        if args[0].shape[-2] <= SLOTS // tp:
            return True
        if len(chunk_call) < Lm:          # the first chunk call's layers
            chunk_call.append((args, kw))
        return False

    def on_step():
        steps_calls.append(tap.calls[-Lm:])
        tap.calls.clear()

    def keep_flash(args, kw):
        q, kf, v = args[:3]
        shapes.add((q.shape[-1], v.shape[-1], q.shape[-2] // kf.shape[-2]))
        return False

    with _Tap(moe_ops, "fused_moe_dispatch_kernel", keep) as tap, \
            _Tap(layers, "flash_attention", keep_flash):
        run = _drive_engine(torch, dev, cfg, mesh, pctx, params, wrappers,
                            on_step=on_step, decode_kernel=None)
        moe_routes = dict(wrappers["fused_moe_dispatch"].route_launches)
    chunks = sum(r.prefill_steps for r in run.reqs)
    flash_n = run.launches["flash_attention"]
    log(f"mla: {flash_n} flash launches ({cfg.num_layers} layers x {chunks} "
        f"chunk calls; the {run.eng.device_calls - chunks} decode calls "
        f"attend in the latent space), (D, Dv, G) {sorted(shapes)}, routes "
        f"{run.routes['flash_attention']}")
    check(shapes == {(D, Dv, 1)} and flash_n == cfg.num_layers * chunks
          and run.routes["flash_attention"]["wgmma"] == flash_n,
          f"mla: flash shapes {shapes}, launches {flash_n}, routes "
          f"{run.routes['flash_attention']}")
    moe_launches = run.launches["fused_moe_dispatch"]
    check(moe_launches == Lm * run.eng.device_calls,
          f"mla dispatch launches {moe_launches} != {Lm} x "
          f"{run.eng.device_calls} device calls")
    log(f"mla: dispatch routes {moe_routes}")
    check(moe_routes["simt"] == 0 and moe_routes["wgmma"] == moe_launches,
          f"mla: a served dispatch launch left the tensor cores: {moe_routes}")
    steps_experts = [_experts_reached(calls, E) for calls in steps_calls]
    log(f"mla: experts reached a decode step (over {Lm} MoE layers): "
        f"median {statistics.median(steps_experts)}, min "
        f"{min(steps_experts)}, max {max(steps_experts)}")
    decode_once = _report_serving(torch, dev, cfg, mesh, params, run,
                                  steps_experts)
    with run.eng.dctx.dispatch_stats.collect() as ds:
        decode_once()
    dropped = float(ds["moe_dropped"].sum())
    routed = float(ds["moe_routed"].sum())
    check(dropped == 0 and routed == Lm * SLOTS * kk,
          f"mla: a decode call dropped {dropped} of {routed} choices")
    log(f"mla: one decode call under a dispatch_stats frame: dropped "
        f"{dropped:.0f} of {routed:.0f} (token, choice) pairs")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"mla: peak device memory while serving {peak:.1f} GB")
    res = {"flash_launches": flash_n, "flash_routes": run.routes[
        "flash_attention"], "dispatch_launches": moe_launches,
        "dispatch_routes": moe_routes, "serving_peak_gb": peak}
    # the dispatch at the served decode and chunk shapes of the last MoE
    # layer, on a copy of its expert weights once the rest of the model is
    # freed: the plain version lifts 128 experts of 7168 x 2048 to f32; the
    # expert MLP's plain version on the chunk's landed blocks, whose
    # batched product broadcasts them over the sources, runs a few experts
    # at a time.  Each stacked leaf is dropped as soon as its layer is
    # copied.
    import gc
    (d_args, d_kw), (c_args, c_kw) = steps_calls[-1][-1], chunk_call[-1]
    names = ("w_gate_e", "w_up_e", "w_down_e")
    stacked = [params[f"layers/{n}"] for n in names]
    for t, a, b in zip(stacked, d_args[3:6], c_args[3:6]):
        mine = t.select(mesh.ndim, Lm - 1)
        check(a.data_ptr() == b.data_ptr() == mine.data_ptr()
              and a.shape == mine.shape, "mla: the tapped dispatch weights "
              "are not the last MoE layer's")
    (d_head, d_tail), (c_head, c_tail) = ((a[:3], a[6:])
                                          for a in (d_args, c_args))
    del d_args, c_args, chunk_call, steps_calls, decode_once, params, mine
    del a, b, t
    run.eng = None
    gc.collect()
    torch.cuda.empty_cache()
    w = []
    while stacked:
        w.append(stacked.pop(0).select(mesh.ndim, Lm - 1).clone())
        torch.cuda.empty_cache()
    d_args, c_args = (*d_head, *w, *d_tail), (*c_head, *w, *c_tail)
    del w
    log(f"mla: the dispatch checks on {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB of live tensors")
    with use_default(DiompContext(mesh=mesh, device=dev)):
        res["dispatch_decode"], _ = _dispatch_at(
            torch, k, "mla decode", d_args, d_kw, d_kw["plan"],
            with_mlp=False)
        # row 7 at E = 256, d = 7168, f = 2048 on the chunk's landed
        # blocks, its plain version 8 experts at a time
        res["dispatch_chunk"], res["mlp_chunk"] = _dispatch_at(
            torch, k, "mla chunk", c_args, c_kw, c_kw["plan"],
            plain_experts=MLA_PLAIN_EXPERTS)
    del d_args, c_args
    torch.cuda.empty_cache()

    # flash at the MLA chunk (512 queries at MAX_LEN - CHUNK over the whole
    # decompressed 4096-row cache, every head its own K/V) and the ring
    # kernel at the same chunk under seq_parallel="ring"'s layout (the
    # chunk's shared queries over each rank's 2048-row stripe)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(*mesh.sizes, 1, CHUNK, H, D, generator=g,
                    device=dev).to(torch.bfloat16)
    kc = torch.randn(*mesh.sizes, 1, MAX_LEN, H, D, generator=g,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn(*mesh.sizes, 1, MAX_LEN, H, Dv, generator=g,
                     device=dev).to(torch.bfloat16)
    p0 = torch.full((*mesh.sizes, 1), MAX_LEN - CHUNK, dtype=torch.int32,
                    device=dev)
    res["flash_chunk"] = _flash_at(torch, k, "mla chunk", q, kc, vc, p0,
                                   p0 + CHUNK, sample=True)
    s_loc = MAX_LEN // tp
    kr, vr = (c[0, 0, :1].unflatten(1, (tp, s_loc)).movedim(1, 0)
              .contiguous() for c in (kc, vc))
    qr = q[0, 0, None].expand(tp, *q.shape[-4:]).contiguous()
    q0 = torch.full((tp, 1), MAX_LEN - CHUNK, dtype=torch.int32, device=dev)
    plan = OverlapPlanner().plan_ring_attention(
        1, CHUNK, s_loc, H, H, D, Dv, torch.bfloat16, tp, q_sharded=False,
        q_offset=None)
    res["ring_chunk"] = _ring_at(torch, k, "mla chunk",
                                 RankMesh(("x",), (tp,)), qr, kr, vr, plan,
                                 q0, q0 + CHUNK)
    del q, kc, vc, kr, vr, qr
    torch.cuda.empty_cache()

    # chunked prefill == token by token (greedy): full width, 1 dense and 1
    # MoE layer of MLA_CUT_EXPERTS experts, float32 weights and cache (the
    # decode steps attend in the latent space, the chunks over K/V
    # decompressed from it); capacity factor MLA_CUT_CF, and the fused
    # dispatch drops nothing either way
    small = dataclasses.replace(full, num_layers=2, first_k_dense=1,
                                num_experts=MLA_CUT_EXPERTS,
                                capacity_factor=MLA_CUT_CF)
    params = sch.init_params(small, mesh, torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
    params = {n: p.float() for n, p in params.items()}
    prompts = [run.rng.randint(0, cfg.vocab_size, n) for n in (5, 37, 70)]
    outs, drops = {}, {}
    for chunk in (1, 32):
        e = run.engine(small, params, slots=SLOTS, max_len=128,
                       prefill_chunk=chunk)
        e.cache = {n: c if n == "pos" else c.float()
                   for n, c in e.cache.items()}
        rs = [e.submit(p, max_new=8) for p in prompts]
        with e.dctx.dispatch_stats.collect() as ds:
            e.run()
        outs[chunk] = [r.out for r in rs]
        drops[chunk] = (float(ds["moe_dropped"].sum()),
                        float(ds["moe_routed"].sum()))
    check(outs[1] == outs[32], f"mla: chunked != token by token: {outs}")
    check(all(dr == 0 and n > 0 for dr, n in drops.values()),
          f"mla: the f32 cut dropped (dropped, routed) {drops}")
    log(f"mla: chunked prefill (32) == token by token over 3 prompts, "
        f"{sum(map(len, outs[1]))} greedy tokens; (dropped, routed) by "
        f"chunk {drops}")
    del params, e
    torch.cuda.empty_cache()
    return res


def gqa_phase(torch, k, dev, wrappers, arch) -> dict:
    """qwen1.5-110b or command-r-plus-104b at full width, depth cut to
    GQA_LAYERS, on glm4-9b's mesh: one CHUNK-token chunk through the
    chunk-prefill step, then GQA_DECODES greedy decode steps on SLOTS slots
    that continue from it, through the decode step; finite logits; every
    flash launch on the route the rule gives G = H_loc / KH_loc (qwen1.5's
    8: the tensor cores; command-r-plus's 12 does not divide 64: the CUDA
    cores); the chunk's flash call timed beside SDPA.  Returns the flash
    entry of the chunk and the phase's flash launches by route."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.interop import stack_shards
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import layers
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve.step import (build_chunk_prefill_step,
                                        build_decode_step)

    full = configs.get(arch)
    cfg = dataclasses.replace(full, num_layers=GQA_LAYERS)
    mesh = make_smoke_mesh(SERVE_RANKS)
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    H = cfg.num_heads // mesh.shape["model"]
    G = H // layers.local_kv_heads(cfg, pctx)
    route = _attention_route(torch, torch.bfloat16, cfg.head_dim,
                             cfg.head_dim, G)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"{arch}: {cfg.name} at {cfg.num_layers} of {full.num_layers} layers "
        f"on {mesh.shape} ({H} heads on {H // G} kv heads a rank: G = {G}, "
        f"head_dim {cfg.head_dim}), {nbytes / 1e9:.2f} GB of random bf16 "
        f"weights in {time.perf_counter() - t0:.1f} s")
    chunk = build_chunk_prefill_step(cfg, mesh, pctx, C=CHUNK,
                                     S_cache=MAX_LEN)
    dec = build_decode_step(cfg, mesh, pctx, B=SLOTS, S=MAX_LEN,
                            slot_pos=True)
    cache = _zero_cache(torch, cfg, mesh, pctx, 1, MAX_LEN, torch.bfloat16,
                        dev)
    rng = np.random.RandomState(2)
    toks = stack_shards(rng.randint(0, cfg.vocab_size, (1, CHUNK)), mesh,
                        chunk.token_spec, device=dev, dtype=torch.int64)
    dctx = DiompContext(mesh=mesh, device=dev)
    with _Tap(layers, "flash_attention",
              lambda a, kw: a[0].shape[-3] == CHUNK) as tap, \
            use_default(dctx):
        _zero_counts(wrappers)
        logits, cache = chunk(params, toks, cache, CHUNK)
        first = tap.calls[0]              # the first layer's flash call
        tap.calls.clear()
        finite = [torch.isfinite(logits).all()]
        # every slot continues from the chunk's rows
        cache = {n: c if n == "pos" else c.expand(
                     *c.shape[:mesh.ndim + 1], SLOTS, *c.shape[mesh.ndim + 2:])
                 .contiguous() for n, c in cache.items()}
        cache["pos"] = stack_shards(np.full(SLOTS, CHUNK, np.int32), mesh,
                                    dec.cache_specs["pos"], device=dev)
        nxt = _greedy(torch, logits, chunk, mesh, dev)[0]
        dtoks = stack_shards(np.repeat(nxt, SLOTS, axis=0), mesh,
                             dec.token_spec, device=dev, dtype=torch.int64)
        for _ in range(GQA_DECODES):
            logits, cache = dec(params, dtoks, cache)
            finite.append(torch.isfinite(logits).all())
            _, dtoks = _greedy(torch, logits, dec, mesh, dev)
        torch.cuda.synchronize()
    launches = wrappers["flash_attention"].launches
    routes = dict(wrappers["flash_attention"].route_launches)
    log(f"{arch}: one {CHUNK}-token chunk and {GQA_DECODES} decode steps on "
        f"{SLOTS} slots: flash launches {launches}, routes {routes} (the "
        f"rule at G = {G}: {route})")
    check(bool(torch.stack(finite).all()), f"{arch}: non-finite logits")
    check(launches == cfg.num_layers * (1 + GQA_DECODES)
          and routes[route] == launches,
          f"{arch}: flash launches {launches}, routes {routes}, not all "
          f"{route}")
    del cache, dtoks
    out = {"launches": launches, "route_launches": routes, "G": G}
    out.update(_flash_call(torch, k, f"{arch} chunk", *first, route=route))
    del first, params
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{arch}: peak device memory {peak:.1f} GB")
    torch.cuda.empty_cache()
    return out


# -- the recurrent families: rwkv6-7b and zamba2-1.2b -------------------------


def _scan_work(BH, T, M, N, chunk, with_s0):
    """(bytes, f32 operations) of one linear-scan call: p, q, a, r (and s0)
    read once, y and the final state written once; the chunked form's
    products, counting only the (t, s) pairs inside the causal mask: per
    chunk of c rows, A (2N a pair), A·p (2M a pair), the readout of the
    carried state and the state update (2MN a row each)."""
    nbytes = 4 * BH * (T * (M + 3 * N) + T * M + M * N * (2 if with_s0 else 1))
    ops = 0
    for c0 in range(0, T, chunk):
        c = min(chunk, T - c0)
        pairs = c * (c + 1) // 2
        ops += pairs * 2 * (M + N) + 4 * c * M * N
    return nbytes, BH * ops


def _scan_at(torch, k, name, args, kw):
    """The scan kernel at one shape of the serving path (the arguments a
    layer gave it): within 2e-4 of the plain version's largest magnitude,
    timed beside it."""
    from repro_torch.kernels.plan import SCAN_CHUNK
    p, q, a, r, s0 = args
    got = k.linear_scan_kernel(*args, **kw)
    want = k.linear_scan_plain(*args, **kw)
    err = max(max_err(torch, g_, w_) for g_, w_ in zip(got, want))
    rel = _scan_err(torch, got, want)
    check(all(bool(torch.isfinite(t).all()) for t in got) and rel <= 2e-4,
          f"linear_scan {name}: relative err {rel:.3g}")
    del got, want
    BH, T, M = p.shape
    N = q.shape[-1]
    nbytes, ops = _scan_work(BH, T, M, N, min(SCAN_CHUNK, T), s0 is not None)
    ms = cuda_ms(torch, lambda: k.linear_scan_kernel(*args, **kw),
                 5 if T > 1 else 50)
    dev = device_ms(torch, lambda: k.linear_scan_kernel(*args, **kw),
                    5 if T > 1 else 50, SCAN_KERNELS)
    plain = cuda_ms(torch, lambda: k.linear_scan_plain(*args, **kw),
                    1 if T > 1 else 10)
    b_ms, b_by = bound(nbytes, ops, "float32")
    log(f"linear_scan {name}: BH {BH}, T {T}, M {M}, N {N}, s0 "
        f"{s0 is not None}: {ms:.4f} ms (device {_ms(dev, 4)}), plain "
        f"{plain:.3f}, bound {b_ms:.4f} ms by {b_by}, err {err:.4g} "
        f"(relative {rel:.3g})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def _recurrent_bounds(cfg, schema, B, T, decode_pos):
    """The least device time (ms) of the prefill call and of one decode
    step, from the model's shapes: every weight but the embedding table
    read once in bf16; two operations a weight a token in bf16 (the shared
    block's weights once an application), the LM head at the last position
    only at prefill; causal attention over the prompt and over
    ``decode_pos`` keys at decode; the scan's f32 operations
    (:func:`_scan_work`); the f32 states read and written.  The bound is
    the largest of the bytes' time and the two types' operation times."""
    from repro_torch.kernels.plan import SCAN_CHUNK
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    hybrid = cfg.family == "hybrid"
    n_app = L // max(cfg.attn_every, 1) if hybrid else 0
    per_tok = weights = 0
    for name, sp in schema.items():
        if name in ("embed/table", "lm_head"):
            continue
        n = math.prod(sp.shape)
        weights += n * (4 if sp.dtype == "float32" else 2)
        shape = sp.shape[1:] if name.startswith("layers/") else sp.shape
        if len(shape) == 2 and min(shape) >= 16:   # a matrix
            per_tok += n * (n_app if name.startswith("shared/") else 1)
    weights += 2 * d * V
    if hybrid:
        H, M, N, D = 2 * d // 64, 64, cfg.ssm_state, cfg.head_dim
        attn_heads = cfg.num_heads
    else:
        H = d // cfg.rwkv_head_dim
        M = N = cfg.rwkv_head_dim
        attn_heads = D = 0
    state = 4 * L * B * H * M * N
    pre_scan = _scan_work(B * H, T, M, N, min(SCAN_CHUNK, T), False)[1]
    dec_scan = _scan_work(B * H, 1, M, N, 1, True)[1]
    pre_ops = (2 * per_tok * B * T + 2 * d * V * B
               + n_app * 2 * B * attn_heads * D * T * (T + 1))
    dec_ops = (2 * per_tok * B + 2 * d * V * B
               + n_app * 4 * B * attn_heads * D * decode_pos)
    kv_read = n_app * B * decode_pos * 2 * cfg.kv_heads * D * 2
    out = []
    for nbytes, bf16_ops, f32_ops in (
            (weights + state, pre_ops, L * pre_scan),
            (weights + 2 * state + kv_read, dec_ops, L * dec_scan)):
        cands = [(nbytes / PEAK_BYTES * 1e3, "bytes"),
                 (bf16_ops / PEAK_OPS["bfloat16"] * 1e3, "operations"),
                 (f32_ops / PEAK_OPS["float32"] * 1e3, "operations")]
        out.append(max(cands))
    return out


def _zero_cache(torch, cfg, mesh, pctx, B, S_cache, dtype, dev,
                seq_sharded=False):
    """A zeroed stacked decode cache laid out from ``cache_structs``."""
    from repro_torch.interop import local_shape
    from repro_torch.models import api

    def zeros(structs, specs):
        if isinstance(structs, dict):
            return {n: zeros(st, specs[n]) for n, st in structs.items()}
        return torch.zeros(local_shape(structs.shape, mesh, specs),
                           dtype=structs.dtype, device=dev)

    return zeros(*api.cache_structs(cfg, mesh, pctx, B, S_cache, dtype=dtype,
                                    seq_sharded=seq_sharded))


def _greedy(torch, logits, step, mesh, dev):
    """Next tokens from vocab-sharded logits: global argmax on the host."""
    from repro_torch.interop import stack_shards, unstack_shards
    full = unstack_shards(logits, mesh, step.logits_spec)      # (B, 1, V)
    nxt = full.argmax(-1).astype("int64")
    return nxt, stack_shards(nxt, mesh, step.token_spec, device=dev,
                             dtype=torch.int64)


def _serve_recurrent(torch, dev, cfg, mesh, pctx, params, B, prompt, steps,
                     S_cache, dctx):
    """One prefill call over ``prompt (B, T)`` from a zero state, then
    ``steps`` greedy decode steps.  Returns (tokens, every step's logits
    finite, prefill ms, decode ms per step, the built steps and cache)."""
    import numpy as np
    from repro_torch.core.context import use_default
    from repro_torch.interop import stack_shards
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    pre = build_prefill_step(cfg, mesh, pctx, B=B, S_cache=S_cache)
    dec = build_decode_step(cfg, mesh, pctx, B=B, S=S_cache)
    cache = _zero_cache(torch, cfg, mesh, pctx, B, S_cache,
                        params["embed/table"].dtype, dev)
    toks = stack_shards(prompt, mesh, pre.token_spec, device=dev,
                        dtype=torch.int64)
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with use_default(dctx):
        a.record()
        logits, cache = pre(params, toks, cache)
        b.record()
        finite = [torch.isfinite(logits).all()]
        out, events = [], []
        nxt, toks = _greedy(torch, logits, pre, mesh, dev)
        out.append(nxt[:, 0])
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, cache = dec(params, toks, cache)
            e1.record()
            events.append((e0, e1))
            finite.append(torch.isfinite(logits).all())
            nxt, toks = _greedy(torch, logits, dec, mesh, dev)
            out.append(nxt[:, 0])
    torch.cuda.synchronize()
    return (np.stack(out, 1), bool(torch.stack(finite).all()),
            a.elapsed_time(b), [x.elapsed_time(y) for x, y in events],
            pre, dec, cache)


def _token_by_token(torch, dev, cfg, mesh, pctx, params, prompt, steps,
                    dctx):
    """Greedy tokens from decoding ``prompt`` one token at a time from a
    zero state (no prefill call), then ``steps`` more."""
    import numpy as np
    from repro_torch.core.context import use_default
    from repro_torch.interop import stack_shards
    from repro_torch.serve.step import build_decode_step
    B, T = prompt.shape
    S_cache = T + steps
    dec = build_decode_step(cfg, mesh, pctx, B=B, S=S_cache)
    cache = _zero_cache(torch, cfg, mesh, pctx, B, S_cache,
                        params["embed/table"].dtype, dev)
    out, finite = [], []
    with use_default(dctx):
        for t in range(T + steps):
            tok = prompt[:, t:t + 1] if t < T else nxt[:, None]
            logits, cache = dec(params, stack_shards(
                tok, mesh, dec.token_spec, device=dev, dtype=torch.int64),
                cache)
            finite.append(torch.isfinite(logits).all())
            nxt, _ = _greedy(torch, logits, dec, mesh, dev)
            nxt = nxt[:, 0]
            if t >= T - 1:
                out.append(nxt)
    return np.stack(out, 1), bool(torch.stack(finite).all())


def recurrent_phase(torch, k, dev, wrappers, arch) -> dict:
    """Serve ``arch`` (rwkv6-7b or zamba2-1.2b) at full width and depth on
    the data 1 x model 2 smoke mesh through the port's prefill and decode
    steps: REC_REQUESTS prompts of REC_PROMPT tokens in one prefill call,
    then REC_NEW greedy decode steps, every wrapper's count zeroed just
    before and read just after; then the scan kernel (and zamba2's flash
    kernel) at the phase's own shapes, and prefill-then-decode against
    token-by-token decode on an f32 cut of the model.  Returns the scan
    kernel's numbers at this phase's prefill and decode shapes, its
    launches, and the flash kernel's numbers under ``"flash"``."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.interop import stack_shards
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import layers, rwkv, ssm
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx

    cfg = configs.get(arch)
    tag = cfg.name.split("-")[0]
    mesh = make_smoke_mesh(SERVE_RANKS)
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    B, T, S_cache = REC_REQUESTS, REC_PROMPT, REC_PROMPT + REC_NEW + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"{tag}: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, {cfg.param_count() / 1e9:.3f} B parameters) on "
        f"{mesh.shape}, {nbytes / 1e9:.2f} GB of random bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    dctx = DiompContext(mesh=mesh, device=dev)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    # warm-up at the phase's own shapes (library handles, allocator pools),
    # off the record
    _serve_recurrent(torch, dev, cfg, mesh, pctx, params, B, prompt, 2,
                     S_cache, dctx)
    module = rwkv if cfg.family == "ssm" else ssm
    scans, flashes = {}, {}

    def keep_scan(args, kw):
        # the models pass the log-decay: kept as the decay the kernel reads
        name = "prefill" if args[0].shape[1] > 1 else "decode"
        if name not in scans:
            kw = dict(kw)
            a = torch.exp(kw.pop("log_a"))
            scans[name] = ((args[0], args[1], a, *args[3:]), kw)
        return False

    def keep_flash(args, kw):
        flashes.setdefault("prefill" if args[0].shape[-3] > 1 else "decode",
                           (args, kw))
        return False

    with _Tap(module, "linear_scan", keep_scan), \
            _Tap(layers, "flash_attention", keep_flash):
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        toks, finite, pre_ms, steps_ms, pre, dec, cache = _serve_recurrent(
            torch, dev, cfg, mesh, pctx, params, B, prompt, REC_NEW,
            S_cache, dctx)
        wall = time.perf_counter() - t0
        launches = {name: wr.launches for name, wr in wrappers.items()}
        scan_routes = dict(wrappers["linear_scan"].route_launches)
        _attention_routes(wrappers, tag)
    log(f"{tag}: {B} prompts of {T} tokens, one prefill call and {REC_NEW} "
        f"greedy decode steps in {wall:.2f} s; launches {launches}")
    L = cfg.num_layers
    n_app = L // cfg.attn_every if cfg.family == "hybrid" else 0
    check(finite and toks.shape == (B, REC_NEW + 1)
          and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
          f"{tag}: bad logits or tokens")
    check(launches["linear_scan"] == L * (1 + REC_NEW),
          f"{tag}: linear_scan launches {launches['linear_scan']} != {L} x "
          f"{1 + REC_NEW} calls")
    # the prefill call's scans on the prefill route, every decode step's on
    # the decode route
    check(scan_routes == {"prefill": L, "decode": L * REC_NEW},
          f"{tag}: linear_scan routes {scan_routes} != {L} prefill + "
          f"{L * REC_NEW} decode")
    log(f"{tag}: linear_scan routes {scan_routes}")
    check(launches["flash_attention"] == n_app * (1 + REC_NEW),
          f"{tag}: flash launches {launches['flash_attention']} != "
          f"{n_app} x {1 + REC_NEW} calls")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("linear_scan", "flash_attention")),
          f"{tag}: unexpected launches {launches}")
    if n_app:
        log(f"{tag}: the shared attention block ran the flash kernel "
            f"{launches['flash_attention']} times ({n_app} applications x "
            f"{1 + REC_NEW} calls)")
    # the served prefill call and REC_PREFILL_REPS more at its shapes, each
    # from a zeroed cache, timed with CUDA events
    ptoks = stack_shards(prompt, mesh, pre.token_spec, device=dev,
                         dtype=torch.int64)
    dtoks = stack_shards(toks[:, -1:], mesh, dec.token_spec, device=dev,
                         dtype=torch.int64)
    fresh = _zero_cache(torch, cfg, mesh, pctx, B, S_cache, torch.bfloat16,
                        dev)
    pre_times = [pre_ms]
    with use_default(dctx):

        def prefill_once():
            pre(params, ptoks, fresh)

        def decode_once():
            dec(params, dtoks, cache)

        for _ in range(REC_PREFILL_REPS):
            pre_times.append(cuda_ms(torch, prefill_once, 1, warmup=0))
        steady = steps_ms[2:]
        pre_b, dec_b = _recurrent_bounds(cfg, sch.build_schema(cfg), B, T,
                                         T + REC_NEW // 2)
        log(f"{tag}: prefill of {B} x {T} tokens: median "
            f"{statistics.median(pre_times):.2f} ms over {len(pre_times)} "
            f"calls (min {min(pre_times):.2f}, max {max(pre_times):.2f}; "
            f"{', '.join(f'{t:.2f}' for t in pre_times)}; bound "
            f"{pre_b[0]:.2f} ms by {pre_b[1]}); decode step median "
            f"{statistics.median(steady):.3f} ms over {len(steady)} steps "
            f"(min {min(steady):.3f}, max {max(steady):.3f}; bound "
            f"{dec_b[0]:.3f} ms by {dec_b[1]}); step over bound "
            f"{statistics.median(steady) / dec_b[0]:.2f}")
        # where a prefill call and a decode step spend their time
        log(f"{tag}: prefill call: {_breakdown(torch, prefill_once, 1)}")
        log(f"{tag}: decode step: {_breakdown(torch, decode_once)}")
    del fresh
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: peak device memory {peak:.1f} GB")

    # the scan kernel at this phase's own shapes (one layer's call each),
    # and zamba2's flash kernel at its shared block's (32 heads on 32 kv
    # heads, head_dim 64): the first prefill and the first decode call
    res = {"launches": launches["linear_scan"], "routes": scan_routes,
           "flash": {}}
    for name in ("prefill", "decode"):
        args, kw = scans[name]
        res[name] = _scan_at(torch, k, f"{tag} {name}", args, kw)
    for name, (args, kw) in sorted(flashes.items()):
        res["flash"][f"{tag}_{name}"] = _flash_call(
            torch, k, f"{tag} {name}", args, kw)
    check(bool(res["flash"]) == bool(n_app),
          f"{tag}: flash calls kept {sorted(flashes)}")
    del scans, flashes, args, kw, cache, params
    torch.cuda.empty_cache()

    # prefill then decode == token by token (greedy), on a float32 cut of
    # the model at full width: 2 layers (zamba2: 6, one application of the
    # shared block), prompts of 100 tokens (a whole chunk and a ragged 36)
    small = dataclasses.replace(cfg, num_layers=6 if n_app else 2)
    params = sch.init_params(small, mesh, torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
    params = {n: p.float() for n, p in params.items()}
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, 100))
    steps = 8
    got, fin1, *_ = _serve_recurrent(torch, dev, small, mesh, pctx, params,
                                     B, prompt, steps, 100 + steps + 1, dctx)
    want, fin2 = _token_by_token(torch, dev, small, mesh, pctx, params,
                                 prompt, steps, dctx)
    check(fin1 and fin2, f"{tag} f32 cut: non-finite logits")
    check((got == want).all(), f"{tag} f32 cut: prefill-then-decode tokens "
          f"{got.tolist()} != token-by-token {want.tolist()}")
    log(f"{tag}: prefill then decode == token by token on a {small.num_layers}"
        f"-layer f32 cut: {got.size} greedy tokens over {B} prompts of 100")
    del params
    torch.cuda.empty_cache()
    return res


def _ring_at(torch, k, name, mesh, q, kk, v, plan, q_offset, valid_len,
             sample=False):
    """The ring kernel at one shape: against its plain version (the
    ``ompx_put`` emulation) on the same inputs, timed beside it and beside
    ``scaled_dot_product_attention`` over the full K/V under the same mask.
    ``q (n, B, tq, H, D)``, ``kk/v (n, B, tk, KH, D)`` on a one-axis ring;
    the offsets are ``(n, B)`` int32 (``q_offset`` each rank's first query
    position).  The launch must take the tensor cores; ``sample`` samples
    the card's clock and power over the kernel's timing."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    group = DiompGroup(("x",), name="x")
    n, B, tq, H, D = q.shape
    tk, KH, Dv = kk.shape[2], kk.shape[3], v.shape[-1]
    kw = dict(plan=plan, q_offset=q_offset, valid_len=valid_len)
    ctx = DiompContext(mesh=mesh, device=q.device)
    with use_default(ctx):
        got = _counted(k.fused_ring_attention_kernel,
                       lambda: k.fused_ring_attention_kernel(q, kk, v, group,
                                                             **kw), "wgmma")
        want = k.fused_ring_attention_plain(q, kk, v, group, **kw)
        err = max_err(torch, got, want)
        # bf16 output: one ulp of the output (2^-7 relative) plus the
        # accumulation order
        check(bool(torch.isfinite(got).all())
              and err <= 1.6e-2 * float(want.float().abs().max()),
              f"ring attention {name}: err {err}")
        del got, want
        reps = 10 if n * tq * tk <= 1 << 22 else 3
        def call():
            return k.fused_ring_attention_kernel(q, kk, v, group, **kw)

        ms = cuda_ms(torch, call, reps)
        if sample:
            sampled_ms(torch, call, ms, f"ring attention {name}")
        dev = device_ms(torch, call, reps, ("ring_attention",))
        plain = cuda_ms(torch, lambda: k.fused_ring_attention_plain(
            q, kk, v, group, **kw), 2)
    # every rank's queries over the whole K/V (the stripes in rank order)
    full_k = kk.movedim(0, 1).flatten(1, 2)           # (B, n tk, KH, D)
    full_v = v.movedim(0, 1).flatten(1, 2)
    t = torch.arange(tq, device=q.device)
    kpos = torch.arange(n * tk, device=q.device)
    qo = q_offset.reshape(n * B, 1, 1)
    vl = valid_len.reshape(n * B, 1, 1)
    visible = (kpos < vl) & ((kpos <= qo + t[:, None]) if plan.causal
                             else True)                # (n B, tq, n tk)
    pairs = int(visible.sum()) * H
    rows_read = int(torch.clamp(valid_len[0], max=n * tk).sum())
    nbytes = q.element_size() * (q.numel() + rows_read * KH * (D + Dv)
                                 + q.numel() // D * Dv)
    ops = 2 * pairs * (D + Dv)
    fk = full_k.expand(n, *full_k.shape).reshape(n * B, n * tk, KH, D)
    fv = full_v.expand(n, *full_v.shape).reshape(n * B, n * tk, KH, Dv)
    sdpa = _sdpa(torch, q.reshape(n * B, tq, H, D), fk, fv, visible)
    library = cuda_ms(torch, sdpa, reps)
    library_dev = device_ms(torch, sdpa, reps, ("",))
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"ring attention {name}: q {tuple(q.shape)} k {tuple(kk.shape)} "
        f"v {tuple(v.shape)} ({pairs // H} visible pairs a head over {n} "
        f"ranks): {ms:.4f} ms (device {_ms(dev, 4)}), plain {plain:.3f}, "
        f"sdpa {library:.4f} (device {_ms(library_dev, 4)}; backend "
        f"{sdpa.backend or 'default'}), bound {b_ms:.4f} ms by {b_by}, "
        f"err {err:.4g}")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
           "device_ms": dev, "library_device_ms": library_dev}
    if sdpa.backend:
        out["library_backend"] = sdpa.backend
    return out


def ring_phase(torch, k, dev, wrappers) -> dict:
    """Serve paligemma-3b at full width and depth through the port's engine
    under ``seq_parallel="ring"`` (glm4-9b's mesh, engine and traffic): the
    chunks run the ring kernel, the decode steps flash at head_dim 256.
    Then one full-width chunk call under "ring" against "allgather", the
    flash kernel at the decode shape, the ring kernel timed at the served
    chunk and at the sequence-parallel shape, and chunked prefill against
    token-by-token on an f32 cut.  Returns the ring kernel's line of the
    ``kernels`` JSON, with flash's paligemma numbers under ``"flash"``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.context import use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.interop import stack_shards
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh, make_smoke_mesh
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve.step import build_chunk_prefill_step

    cfg = configs.get(RING_ARCH)
    mesh = make_smoke_mesh(SERVE_RANKS)
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                 seq_parallel="ring")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"paligemma: {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, {cfg.num_heads} heads on {cfg.kv_heads} kv head, head_dim "
        f"{cfg.head_dim}) on {mesh.shape} under seq_parallel='ring', "
        f"{nbytes / 1e9:.2f} GB of random bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    run = _drive_engine(torch, dev, cfg, mesh, pctx, params, wrappers,
                        chunk_kernel="fused_ring_attention")
    _report_serving(torch, dev, cfg, mesh, params, run)
    eng, nd = run.eng, mesh.ndim
    check(all(c == 0 for name, c in run.launches.items()
              if name not in ("fused_ring_attention", "flash_attention")),
          f"paligemma: unexpected launches {run.launches}")

    # one full-width chunk call under "ring" against the same call under
    # "allgather", each on a copy of slot 0's cache at RING_CHUNK_AT: as
    # served (bf16) and with the weights and cache in f32.  Tolerances,
    # relative to the logits' largest magnitude: f32 1e-4, rounding in the
    # two fold orders (1.3e-5 measured on the H100 at 18 layers); bf16 1e-1,
    # the same difference after every layer's outputs round to bf16 at other
    # places — it compounds over the 18 layers (3.8e-2 measured; 3.9e-3 at
    # 2 layers, inside the model tests' 2e-2)
    toks = stack_shards(run.rng.randint(0, cfg.vocab_size, (1, CHUNK)), mesh,
                        eng.chunk_step.token_spec, device=dev,
                        dtype=torch.int64)
    eng.host_pos[0] = RING_CHUNK_AT
    steps = {sp: build_chunk_prefill_step(
        cfg, mesh, dataclasses.replace(pctx, seq_parallel=sp), C=CHUNK,
        S_cache=MAX_LEN) for sp in ("ring", "allgather")}
    for dt, tol in ((torch.bfloat16, 1e-1), (torch.float32, 1e-4)):
        weights = {name: p.to(dt) for name, p in params.items()}
        logits = {}
        for sp, step in steps.items():
            cache = {name: c if name == "pos" else c.to(dt)
                     for name, c in eng._slot_cache(0).items()}
            with use_default(eng.dctx):
                logits[sp] = step(weights, toks, cache, CHUNK)[0]
        del weights, cache
        err = max_err(torch, logits["ring"], logits["allgather"])
        scale = float(logits["allgather"].abs().max())
        check(bool(torch.isfinite(logits["ring"]).all())
              and err <= tol * scale,
              f"paligemma: {dt} ring chunk logits differ from allgather by "
              f"{err} (scale {scale})")
        log(f"paligemma: a {CHUNK}-token chunk at {RING_CHUNK_AT} in {dt} "
            f"under 'ring' == 'allgather' to max |err| {err:.4g} of logits "
            f"up to {scale:.4g}")
    del logits, steps
    torch.cuda.empty_cache()

    # flash at the decode shape (8 heads on 1 kv head, head_dim 256) and
    # the ring kernel at the served chunk: 512 shared queries at
    # RING_CHUNK_AT over each rank's 2048-row stripe of the served cache
    g = torch.Generator(device=dev).manual_seed(5)
    H, hd = cfg.num_heads, cfg.head_dim
    ends = [len(r.prompt) + r.max_new - 1 for r in run.reqs[-SLOTS:]]
    pos = torch.tensor(ends, dtype=torch.int32, device=dev).expand(
        *mesh.sizes, SLOTS).contiguous()
    q = torch.randn(*mesh.sizes, SLOTS, 1, H, hd, generator=g,
                    device=dev).to(torch.bfloat16)
    kc, vc = eng.cache["k"].select(nd, 0), eng.cache["v"].select(nd, 0)
    flash = {"paligemma_decode": _flash_at(torch, k, "paligemma decode", q,
                                           kc, vc, pos, pos + 1,
                                           min_blocks=132)}
    n = mesh.shape["model"]
    s_loc = MAX_LEN // n
    ring_mesh = RankMesh(("x",), (n,))
    # rank r's stripe: rows [r s_loc, (r + 1) s_loc) of slot 0's cache
    # (replicated over "model"; rank 0's copy)
    kk, vv = (c[0, 0, :1].unflatten(1, (n, s_loc)).movedim(1, 0).contiguous()
              for c in (kc, vc))
    q = torch.randn(n, 1, CHUNK, H, hd, generator=g, device=dev).to(
        torch.bfloat16)
    q0 = torch.full((n, 1), RING_CHUNK_AT, dtype=torch.int32, device=dev)
    plan = OverlapPlanner().plan_ring_attention(
        1, CHUNK, s_loc, H, cfg.kv_heads, hd, hd, torch.bfloat16, n,
        q_sharded=False, q_offset=None)
    line = {"name": "fused_ring_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/ring_attention.cu",
            "replaces": "src/repro/kernels/ring_attention/fused.py:362",
            "launches": run.launches["fused_ring_attention"],
            "shape": "served chunk",
            "route_launches": run.routes["fused_ring_attention"]}
    line.update(_ring_at(torch, k, "served chunk", ring_mesh, q, kk, vv,
                         plan, q0, q0 + CHUNK))
    # row 9 under chaos at the served chunk
    ring_group = DiompGroup(("x",), name="x")
    _chaos_path(torch, "ring attention served chunk", wrappers,
                ["fused_ring_attention"], _in_context(
                    ring_mesh, dev, lambda: k.fused_ring_attention_kernel(
                        q, kk, vv, ring_group, plan=plan, q_offset=q0,
                        valid_len=q0 + CHUNK)))
    del eng, q, kc, vc, kk, vv
    run.eng = None
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"paligemma: peak device memory {peak:.1f} GB")
    del params
    torch.cuda.empty_cache()

    # the sequence-parallel shape: SEQ_RANKS virtual ranks of SEQ_T_LOC
    # tokens each, queries sharded, causal, paligemma's head layout
    n, t_loc = SEQ_RANKS, SEQ_T_LOC
    q = torch.randn(n, 1, t_loc, H, hd, generator=g, device=dev).to(
        torch.bfloat16)
    kk, vv = (torch.randn(n, 1, t_loc, cfg.kv_heads, hd, generator=g,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    q0 = (torch.arange(n, dtype=torch.int32, device=dev) * t_loc)[:, None]
    vl = torch.full((n, 1), n * t_loc, dtype=torch.int32, device=dev)
    plan = OverlapPlanner().plan_ring_attention(
        1, t_loc, t_loc, H, cfg.kv_heads, hd, hd, torch.bfloat16, n)
    line["seq_parallel"] = _ring_at(torch, k, "sequence-parallel",
                                    RankMesh(("x",), (n,)), q, kk, vv, plan,
                                    q0, vl, sample=True)
    del q, kk, vv
    torch.cuda.empty_cache()

    # chunked prefill == token by token (greedy) under "ring", at full width
    # with the depth cut to 2 layers and float32 weights, as for glm4-9b
    small = dataclasses.replace(cfg, num_layers=2)
    params = sch.init_params(small, mesh, torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
    params = {name: p.float() for name, p in params.items()}
    prompts = [run.rng.randint(0, cfg.vocab_size, m) for m in (5, 37, 70)]
    outs = {}
    for chunk in (1, 32):
        e = run.engine(small, params, slots=SLOTS, max_len=128,
                       prefill_chunk=chunk)
        e.cache = {name: c if name == "pos" else c.float()
                   for name, c in e.cache.items()}
        rs = [e.submit(p, max_new=8) for p in prompts]
        e.run()
        outs[chunk] = [r.out for r in rs]
    check(outs[1] == outs[32], f"paligemma: chunked != token by token: "
          f"{outs}")
    log(f"paligemma: chunked prefill (32, the ring) == token by token over 3 "
        f"prompts, {sum(map(len, outs[1]))} greedy tokens")
    del params
    torch.cuda.empty_cache()
    line["flash"] = flash
    return line


# -- the unified runtime (Fig. 1(b)) and the hierarchical backend -------------


def runtime_phase(torch, dev) -> dict:
    """glm4-9b's full-width, full-depth parameter tree registered through
    ``DiompRuntime`` on the 8-rank smoke mesh (every row's bytes a rank
    equal to ``param_bytes_per_device``, the arena's bytes in use to their
    sum); its embedding table placed on the card and read back; a gradient
    of the table's shape on every rank all-reduced over DP = (pod, data)
    through a flat and a hierarchical handle (equal within bf16's rounding,
    call and byte logs as the CPU tests pin them, each timed with CUDA
    events); the host time of one ``ompccl.allreduce`` call of a 4 KiB
    payload, which is ``LinkModel.dispatch_s``.  On one card every rank's
    "wire" is device memory: the times are copies and sums in HBM, not
    NVLink or network transfers."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import ompccl
    from repro_torch.core.backends import (LinkModel,
                                           hierarchical_allreduce_time,
                                           ring_allreduce_time)
    from repro_torch.core.context import default_context, \
        reset_default_context
    from repro_torch.core.runtime import DiompRuntime, dtype_bytes
    from repro_torch.distributed.hierarchical import inter_pod_traffic_bytes
    from repro_torch.distributed.sharding import param_bytes_per_device
    from repro_torch.interop import local_shape, unstack_shards
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.schema import build_schema

    mesh = make_smoke_mesh(RT_RANKS)
    cfg = configs.get(RT_ARCH)
    schema = build_schema(cfg)
    rt = DiompRuntime(mesh, device=dev)
    check(default_context() is rt.ctx, "runtime: its context is not the "
          "process default")
    t0 = time.perf_counter()
    rows = rt.register_pytree("params", {
        n: (p.shape, p.dtype, p.axes) for n, p in sorted(schema.items())})
    reg_ms = (time.perf_counter() - t0) * 1e3
    total = 0
    for n, row in rows.items():
        p = schema[n]
        want = param_bytes_per_device(p.shape, dtype_bytes(p.dtype), p.axes,
                                      mesh)
        check(row.region.sizes == (want,) * mesh.size,
              f"runtime: {n} holds {row.region.sizes} bytes a rank, not "
              f"{want}")
        total += want
    # every row is a multiple of the arena's 256-byte alignment here, so
    # the bytes in use are exactly the rows' sum
    for r in range(mesh.size):
        check(rt.bytes_in_use(r) == total, f"runtime: rank {r} uses "
              f"{rt.bytes_in_use(r)} bytes, the rows sum to {total}")
    whole = sum(math.prod(p.shape) * dtype_bytes(p.dtype)
                for p in schema.values())
    log(f"runtime: {cfg.name} at full width and depth (d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.num_layers} layers; {whole / 1e9:.3f} GB) registered on "
        f"{mesh.shape}: {len(rows)} rows, {total} bytes a rank "
        f"({total / 1e9:.3f} GB), in {reg_ms:.2f} ms")

    # placement: the embedding table from the host onto the card
    name = "params/embed/table"
    V, D = rt.lookup(name).shape
    g = torch.Generator(device=dev).manual_seed(2)
    host = torch.randn(V, D, generator=g, device=dev,
                       dtype=torch.bfloat16).cpu()
    t0 = time.perf_counter()
    placed = rt.place(name, host)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    spec = rt.sharding_for(name).spec
    check(placed.device.type == dev.type and tuple(placed.shape)
          == local_shape((V, D), mesh, spec),
          f"runtime: placed {tuple(placed.shape)} on {placed.device}")
    check(np.array_equal(unstack_shards(placed, mesh, spec),
                         host.float().numpy()),
          "runtime: unstack_shards of the placed table is not the host value")
    log(f"runtime: placed {name} ({V} x {D} bf16, spec {spec}) as "
        f"{tuple(placed.shape)} on the card in {place_s:.3f} s; "
        f"unstack_shards gives back the host value")
    del placed, host

    # flat against hierarchical over DP = (pod, data)
    dp = rt.group("dp")
    grad = torch.randn(*mesh.sizes, V, D, generator=g, device=dev,
                       dtype=torch.bfloat16)
    payload = V * D * grad.element_size()
    handles = {"flat": rt.communicator(dp),
               "hierarchical": rt.communicator(dp, backend="hierarchical")}
    outs = {}
    for tag, comm in handles.items():
        rt.ctx.reset_stats()
        outs[tag] = comm.allreduce(grad)
        logs = (rt.ctx.stats(), rt.ctx.byte_stats())
        check(logs == ({dp.descriptor(): {"allreduce": 1}},
                       {dp.descriptor(): {"allreduce": payload}}),
              f"runtime: {tag} all-reduce logged {logs}")
    torch.cuda.synchronize()
    err = scale = 0.0
    for a, b in zip(outs["flat"].view(mesh.size, -1),
                    outs["hierarchical"].view(mesh.size, -1)):
        err = max(err, float((a.float() - b.float()).abs().max()))
        scale = max(scale, float(a.float().abs().max()))
    check(err <= 4 * BF16_U * scale, f"runtime: flat vs hierarchical err "
          f"{err} (max |sum| {scale})")
    # the flat sum within one rounding of the f32 sum (first 4096 rows)
    want = grad[..., :4096, :].float().sum((0, 1))
    got = outs["flat"][0, 0, :, :4096].float()
    ref_err = float((got - want).abs().max())
    check(ref_err <= BF16_U * float(want.abs().max()),
          f"runtime: flat all-reduce vs f32 sum err {ref_err}")
    del outs, want, got
    torch.cuda.empty_cache()
    ms = {tag: cuda_ms(torch, lambda c=comm: c.allreduce(grad), 3)
          for tag, comm in handles.items()}
    fast, slow = mesh.shape["data"], mesh.shape["pod"]
    wire = {"flat": {"inter_pod": inter_pod_traffic_bytes(
                payload, fast, slow, hierarchical=False),
                     "intra_pod": 2 * payload * (fast * slow - 1)
                     / (fast * slow)},
            "hierarchical": {"inter_pod": inter_pod_traffic_bytes(
                payload, fast, slow),
                "intra_pod": 2 * payload * (fast - 1) / fast}}
    link = LinkModel()
    modeled = {"flat": ring_allreduce_time(payload, fast * slow, link),
               "hierarchical": hierarchical_allreduce_time(payload, fast,
                                                           slow, link)}
    for tag in handles:
        log(f"runtime: {tag} all-reduce of {tuple(grad.shape)} bf16 "
            f"({payload / 1e9:.3f} GB a rank, {grad.numel() * 2 / 1e9:.2f} "
            f"GB stacked) over dp: {ms[tag]:.3f} ms (CUDA events; device "
            f"memory, not NVLink); bytes a rank sends by the reference's "
            f"formulas: inter-pod {wire[tag]['inter_pod']:.0f}, intra-pod "
            f"{wire[tag]['intra_pod']:.0f}; modeled on NVLink / "
            f"ConnectX-7: {modeled[tag] * 1e3:.3f} ms")
    log(f"runtime: flat vs hierarchical max |err| {err:.4g} (max |sum| "
        f"{scale:.4g}, bound {4 * BF16_U * scale:.4g}); flat vs the f32 sum "
        f"{ref_err:.4g}")
    del grad
    torch.cuda.empty_cache()

    # the host's time to issue one all-reduce (the free function, through
    # the runtime's default context), with the garbage collector off while
    # the calls are timed, as ``timeit`` does
    x = torch.zeros(*mesh.sizes, DISPATCH_BYTES // 4, device=dev)
    gc.collect()
    gc.disable()
    try:
        gaps = [host_and_events(torch, lambda: ompccl.allreduce(x, dp),
                                DISPATCH_REPS)
                for _ in range(DISPATCH_TIMINGS)]
    finally:
        gc.enable()
    host_us = sorted(g_["host_ms"] * 1e3 for g_ in gaps)
    event_us = sorted(g_["event_ms"] * 1e3 for g_ in gaps)
    gap = {"host_ms": statistics.median(host_us) / 1e3,
           "host_min_ms": host_us[0] / 1e3,
           "event_ms": statistics.median(event_us) / 1e3}
    log(f"runtime: one ompccl.allreduce of {DISPATCH_BYTES} B a rank over "
        f"dp: host {host_us[0]:.2f} us a call at the least, "
        f"{gap['host_ms'] * 1e3:.2f} the median ({DISPATCH_TIMINGS} x "
        f"{DISPATCH_REPS} calls; {', '.join(f'{u:.2f}' for u in host_us)}),"
        f" events {gap['event_ms'] * 1e3:.2f} us (LinkModel.dispatch_s "
        f"{link.dispatch_s * 1e6:.2f} us)")
    check(abs(gap["host_min_ms"] / 1e3 / link.dispatch_s - 1)
          <= DISPATCH_BAND,
          f"runtime: the least dispatch time {host_us[0]:.2f} us lies "
          f"outside {DISPATCH_BAND:.0%} of LinkModel.dispatch_s "
          f"({link.dispatch_s * 1e6:.2f} us)")
    rt.close()
    reset_default_context()
    return {"rows": len(rows), "bytes_per_rank": total,
            "register_ms": reg_ms, "place_s": place_s,
            "allreduce_ms": ms, "allreduce_err": err,
            "allreduce_scale": scale, "payload_bytes": payload,
            "wire_bytes": wire, "modeled_s": modeled,
            "dispatch_host_ms": gap["host_ms"],
            "dispatch_host_min_ms": gap["host_min_ms"],
            "dispatch_event_ms": gap["event_ms"]}


# -- the paper's examples -------------------------------------------------------


def _run_example(main, argv):
    """An example's ``main(argv)`` with what it prints sent to the log;
    returns its result and its printed lines."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    return out, lines


def _minimod_launches(torch, st_fused, r) -> dict:
    """The stencil launches (count, per route) that a Minimod run like
    ``r`` makes on the card, by ``fused_step_route``: a step the fused
    kernel takes is one launch of it; a step the emulation takes is one
    ``leap`` a pass of the plan's schedule.  Every launch is on the TMA
    ring: f32, rows of 4096 (and 4128) bytes, every slice 16-byte aligned."""
    carried = r.mode != "host"   # fused carries halos; none passes its own
    route = st_fused.fused_step_route(
        on_card=True, dtype=torch.float32, dim=5, ny=r.ny,
        z_extents=None if len(set(r.z_extents)) == 1 else r.z_extents,
        plan=r.plan, halos=st_fused.Halos() if carried else None,
        return_halos=r.mode == "fused")
    if route != "emulation":
        fused, leaps = r.steps, 0
    else:
        sched = r.plan.schedule(carried=carried)
        fused = 0
        leaps = r.steps * (1 if "all" in sched
                           else 1 + 2 * (r.nz > 1) + 2 * (r.ny > 1))
    return {"wave_step": (leaps, {"simt": 0, "tma": leaps}),
            "fused_wave_step": (fused, {"simt": 0, "tma": fused})}


def _minimod_argv(grid: int, kw: dict) -> list:
    """The Minimod example's flags for ``run_minimod(**kw)`` at ``grid``."""
    argv = ["--grid", str(grid), "--steps", str(STEPS), "--mode", kw["mode"],
            "--nz", str(kw.get("nz", NZ)), "--ny", str(kw.get("ny", 1))]
    if "weights" in kw:
        argv += ["--weights", ",".join(str(w) for w in kw["weights"])]
    return argv


def examples_phase(torch, k, dev, wrappers, kernels) -> dict:
    """The paper's examples on the card, through their own ``main``:
    quickstart; Cannon at N = 30240 (f32, 8 ranks: 64 launches of the
    matmul kernel on its CUDA-core route, relative error < 1e-4), with the
    kernel's device time at that block shape; Minimod at 1024³, nz = 4, 10
    steps in four runs (none, fused, fused asymmetric, fused 2-D), each
    with its asserts, its launches by kernel and route as
    ``fused_step_route`` predicts them, the same run on random fields
    against the single-grid oracle (so every pass of the emulation's
    ``leap`` is held at 1024³, on tiles that all carry data), and a 64³ run
    of the same mode and decomposition equal to a ``device="cpu"`` run;
    ``halo_loc``.  Adds
    the examples' launches to ``kernels``' lines (``launches_by_path``)."""
    from repro_torch.apps.minimod import halo_loc, run_minimod
    from repro_torch.core.context import reset_default_context
    from repro_torch.examples import cannon_matmul, minimod, quickstart
    from repro_torch.kernels.stencil import fused as st_fused
    from repro_torch.kernels.stencil.ref import wave_step_ref
    lines_of = {e["name"]: e for e in kernels}
    result = {}

    on = ["--device", dev.type]
    _, lines = _run_example(quickstart.main, on)
    check(lines[-1] == "quickstart OK", f"quickstart: {lines[-1:]}")
    reset_default_context()

    # Cannon at Fig. 7's N
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    out, lines = _run_example(cannon_matmul.main, [str(CANNON_N)] + on)
    wall = time.perf_counter() - t0
    launches = {name: wr.launches for name, wr in wrappers.items()}
    routes = dict(wrappers["matmul"].route_launches)
    del out["C"]
    torch.cuda.empty_cache()
    n2 = CANNON_RANKS * CANNON_RANKS
    check(lines[-1] == "cannon_matmul OK" and out["err"] < 1e-4,
          f"cannon: err {out['err']}")
    check(launches["matmul"] == n2 and routes == {"simt": n2, "wgmma": 0}
          and sum(launches.values()) == n2,
          f"cannon: launches {launches}, matmul routes {routes}")
    ns = CANNON_N // CANNON_RANKS
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(ns, ns, generator=g, device=dev)
    b = torch.randn(ns, CANNON_N, generator=g, device=dev)
    got, want = k.matmul_kernel(a, b), k.matmul_ref(a, b)
    err = max_err(torch, got, want)
    check(err <= 1e-5 * float(want.abs().max()), f"cannon block GEMM: {err}")
    del got, want
    mm_ms = cuda_ms(torch, lambda: k.matmul_kernel(a, b), 3)
    mm_dev = device_ms(torch, lambda: k.matmul_kernel(a, b), 3,
                       MATMUL_KERNELS)
    b_ms, b_by = bound(4 * (ns * ns + 2 * ns * CANNON_N),
                       2 * ns * ns * CANNON_N, "float32")
    block = {"shape": [ns, ns, CANNON_N], "dtype": "float32",
             "max_abs_err": err, "ms": mm_ms, "device_ms": mm_dev,
             "plain_ms": cuda_ms(torch, lambda: k.matmul_ref(a, b), 3),
             "library_ms": cuda_ms(torch, lambda: torch.matmul(a, b), 3),
             "bound_ms": b_ms, "bound_by": b_by}
    del a, b
    torch.cuda.empty_cache()
    log(f"cannon N = {CANNON_N} on {CANNON_RANKS} ranks: {out['ms']:.1f} ms "
        f"(CUDA events; {wall:.1f} s with the data, the f32 check and the "
        f"host), rel err {out['err']:.3g}; {n2} matmul launches {routes}; "
        f"one block GEMM ({ns} x {ns}) @ ({ns} x {CANNON_N}) f32: "
        f"{mm_ms:.3f} ms, device {_ms(mm_dev, 3)}, plain "
        f"{block['plain_ms']:.3f}, torch.matmul {block['library_ms']:.3f}, "
        f"bound {b_ms:.3f} ms by {b_by}")
    row = lines_of["matmul"]
    row["launches_by_path"] = {"ring": row["launches"], "cannon": n2}
    row["launches"] += n2
    for r_, c in routes.items():
        row["route_launches"][r_] += c
    row["cannon"] = {"ms": out["ms"], "rel_err": out["err"], "block": block}
    result["cannon"] = row["cannon"]

    # Minimod at Fig. 8's size, four runs; random fields and their
    # single-grid oracle for the runs' field checks (tolerance as the main
    # path's: 1e-5 of the largest value)
    g = torch.Generator(device=dev).manual_seed(4)
    u0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    up0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    oracle, up = u0, up0
    for _ in range(STEPS):
        oracle, up = wave_step_ref(oracle, up, 0.1), oracle
    del up
    oracle_max = float(oracle.abs().max())
    runs = {}
    for tag, kw in MINIMOD_RUNS:
        argv = _minimod_argv(GRID, kw)
        _zero_counts(wrappers)
        r, lines = _run_example(minimod.main, argv + on)
        d = _stencil_counts(k)
        want = _minimod_launches(torch, st_fused, r)
        check(lines[-1] == "minimod OK", f"minimod {tag}: {lines[-1:]}")
        check(r.mode != "fused" or r.put_bytes == r.tracker_put_bytes > 0,
              f"minimod {tag}: put bytes {r.put_bytes} vs tracker "
              f"{r.tracker_put_bytes}")
        check(d == want, f"minimod {tag}: launches {d}, predicted {want}")
        step_ms = r.wall_s / r.steps * 1e3
        del r
        # the same run again, warm
        again, _ = _run_example(minimod.main, argv + on)
        runs[tag] = {"ms_per_step": step_ms,
                     "ms_per_step_again": again.wall_s / again.steps * 1e3,
                     "launches": d, "z_extents": list(again.z_extents),
                     "nz": again.nz, "ny": again.ny}
        del again
        if d["wave_step"][0]:
            # where the emulation's step spends the card's time (one more
            # run after a warm one)
            run = lambda: _run_example(  # noqa: E731
                minimod.main, argv + on)
            runs[tag]["breakdown"] = _breakdown(torch, run, 1)
            log(f"minimod {tag} at {GRID}^3, one run: "
                f"{runs[tag]['breakdown']}")
        # the same decomposition on random fields, through the same
        # launches, against the single-grid oracle
        before = _stencil_counts(k)
        rnd = run_minimod(grid=(GRID,) * 3, steps=STEPS, u0=u0, u_prev0=up0,
                          device=dev, **{"nz": NZ, **kw})
        rnd_d = _stencil_delta(before, _stencil_counts(k))
        check(rnd_d == want, f"minimod {tag} on random fields: launches "
              f"{rnd_d}, predicted {want}")
        e = max_err(torch, rnd.field, oracle)
        check(rnd.field.shape == oracle.shape
              and bool(torch.isfinite(rnd.field).all())
              and e <= 1e-5 * oracle_max,
              f"minimod {tag} at {GRID}^3 on random fields: err {e} vs the "
              f"single-grid oracle (max |u| {oracle_max})")
        runs[tag]["oracle_err"] = e
        runs[tag]["ms_per_step_random"] = rnd.wall_s / rnd.steps * 1e3
        del rnd
        small = _minimod_argv(PARITY_GRID, kw)
        card, _ = _run_example(minimod.main, small + on)
        cpu, _ = _run_example(minimod.main, small + ["--device", "cpu"])
        e = max_err(torch, card.field.cpu(), cpu.field)
        check(e <= 1e-5 * float(cpu.field.abs().max()),
              f"minimod {tag} at {PARITY_GRID}^3: card vs cpu err {e}")
        for attr in MINIMOD_COUNTERS:
            check(getattr(card, attr) == getattr(cpu, attr),
                  f"minimod {tag} at {PARITY_GRID}^3: {attr} "
                  f"{getattr(card, attr)} vs {getattr(cpu, attr)}")
        runs[tag]["parity_err"] = e
        log(f"minimod {tag} at {GRID}^3: {step_ms:.3f} ms a step (again: "
            f"{runs[tag]['ms_per_step_again']:.3f}; on random fields: "
            f"{runs[tag]['ms_per_step_random']:.3f}); launches {d}; on "
            f"random fields max |err| {runs[tag]['oracle_err']:.4g} vs the "
            f"single-grid oracle (max |u| {oracle_max:.4g}); at "
            f"{PARITY_GRID}^3 card == cpu (err {e:.3g}, counters equal)")
    for name, path in (("wave_step", "wave_step"),
                       ("fused_wave_step", "fused_wave_step")):
        row = lines_of[name]
        row["launches_by_path"] = {"main": row["launches"]}
        for tag, run in runs.items():
            n, rts = run["launches"][path]
            row["launches_by_path"][f"minimod example {tag}"] = n
            row["launches"] += n
            for r_, c in rts.items():
                row["route_launches"][r_] += c
    del u0, up0, oracle
    torch.cuda.empty_cache()
    result["minimod"] = runs
    loc = halo_loc()
    log(f"halo_loc: one-sided (Listing 1) {loc['diomp']} lines, two-sided "
        f"(Listing 2) {loc['two_sided']}")
    check(loc["diomp"] < loc["two_sided"], f"halo_loc: {loc}")
    result["halo_loc"] = loc
    return result


# -- the training phase ----------------------------------------------------------

TRAIN_ARCH = "stablelm-3b"
TRAIN_MESH = "data=2,model=2"   # FSDP over data, TP over model, one card
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 4
TRAIN_CUT_LAYERS = 2            # the checks' depth cut, full width
TRAIN_CHECK_MESH = "pod=2,data=2,model=2"
TRAIN_LR = 1e-4                 # the checks' constant learning rate
TRAIN_B1 = 0.9                  # the checks' AdamW first-moment decay
FLASH_BWD_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel",
                     "bwd_rows_kernel", "dkdv_tc_kernel", "dkdv_wide_kernel",
                     "dq_tc_kernel")


def _layer_matrix_weights(cfg, spec, prefixes=("layers/", "dense_layers/")
                          ) -> int:
    """Weights of the layers' matrices that a token passes through (the
    stacks under ``prefixes``: the layers and deepseek-v3's leading dense
    layers; the routed experts' 4-D stacks apart): the audio encoder's
    GELU MLP leaves its schema's ``w_gate`` unread."""
    unread = ("layers/w_gate",) if cfg.family == "audio" else ()
    return sum(math.prod(s.shape) for n, s in spec.items()
               if n.startswith(prefixes) and len(s.shape) == 3
               and n not in unread)


def _attn_pairs(T: int, causal: bool) -> int:
    """(query, key) pairs of one head over a T-token sequence."""
    return T * (T + 1) // 2 if causal else T * T


def _train_flops(cfg, tokens: int, seq: int = None) -> float:
    """Operations of one training step under remat: 8 a token for each
    weight of the layers' matrices (forward, recomputed forward, backward
    twice the forward; zamba2's shared block's once for each of its
    applications; deepseek-v3's leading dense layers and MLA's own
    matrices included), 6 for each weight of the head (LM or masked-frame;
    never recomputed), none for the embedding lookup and the norms; plus
    the attention's score products over the visible pairs (causal, or all
    of them for the encoder): 2 (D + Dv) a pair and head forward, twice,
    and 2 (3 D + 2 Dv) backward (D = Dv = head_dim, or MLA's D = dn + dr
    and Dv = v_head_dim), in each attention layer (zamba2: each
    application of the shared block; rwkv6: none); plus, for the MoE
    family, only the routed experts a token reaches: 8 x k x 3 x d x f a
    token a MoE layer (the capacity drops not subtracted); plus, with
    multi-token prediction, its module over the T - 1 positions it sees:
    the projection of [h; e] at 6 a weight (not recomputed), its layer at 8
    and its attention as above, and a second LM-head pass at 6 a weight
    over the T - 2 positions it scores.  The recurrent scans' own products
    (about a hundredth of the weights' at these widths) are left out."""
    from repro_torch.models import schema

    seq = TRAIN_SEQ if seq is None else seq
    spec = schema.build_schema(cfg)
    head = next(h for h in ("lm_head", "head", "embed/table") if h in spec)
    n_app = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    shared = sum(math.prod(s.shape) for n, s in spec.items()
                 if n.startswith("shared/") and len(s.shape) == 2)
    per_token = 6 * math.prod(spec[head].shape) \
        + 8 * (_layer_matrix_weights(cfg, spec) + n_app * shared)
    if cfg.moe:
        moe_layers = cfg.num_layers - cfg.first_k_dense
        per_token += 8 * cfg.experts_per_token * 3 * cfg.d_model \
            * cfg.moe_d_ff * moe_layers
    attn_layers = n_app if cfg.family == "hybrid" else cfg.num_layers
    if cfg.attention == "mla":
        D, Dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        D = Dv = cfg.head_dim
    per_pair = cfg.num_heads * (2 * 2 * (D + Dv) + 2 * (3 * D + 2 * Dv))
    seqs = tokens / seq
    total = per_token * tokens \
        + per_pair * attn_layers * _attn_pairs(seq, cfg.causal) * seqs
    if cfg.mtp:
        total += seqs * (
            (seq - 1) * (6 * math.prod(spec["mtp/proj"].shape)
                         + 8 * _layer_matrix_weights(cfg, spec,
                                                     ("mtp/layer/",)))
            + per_pair * _attn_pairs(seq - 1, cfg.causal)
            + (seq - 2) * 6 * math.prod(spec[head].shape))
    return total


def _sdpa_grad(torch, q, kk, v, do, causal=True, pin=False):
    """SDPA's backward alone on its own forward (the library's yardstick
    for the gradient kernel, never called by the port): q, k, v and dO in
    the flash kernel's layout.  Where Dv != D (MLA), or where ``pin`` asks,
    the forward, and so its backward, is pinned to the first backend in
    PyTorch's order whose forward and backward take it; ``.backend`` names
    it (None: PyTorch's own pick)."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (t.reshape(-1, *t.shape[-3:]).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (q, kk, v))
    do4 = do.reshape(-1, *do.shape[-3:]).transpose(1, 2).contiguous()
    backends = [None] if v.shape[-1] == q.shape[-1] and not pin else [
        SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    for b in backends:
        try:
            with warnings.catch_warnings(), (
                    sdpa_kernel(b) if b is not None
                    else contextlib.nullcontext()):
                warnings.simplefilter("ignore")   # each refusal says why
                o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=causal)
                torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def call(o4=o4):
            return torch.autograd.grad(o4, (q4, k4, v4), do4,
                                       retain_graph=True)
        call.backend = None if b is None else b.name
        return call
    raise RuntimeError(f"no SDPA backend differentiates q {tuple(q.shape)}, "
                       f"v {tuple(v.shape)}")


def _bwd_at(torch, k, q, kk, v, do, causal=True):
    """The backward kernel at the training path's shape against its plain
    version (and a second launch, equal bit for bit) and SDPA's backward,
    with its bound (operations at the bf16
    tensor-core rate: S, dP, dv, dq and dk over the visible (row, key)
    pairs; bytes: q, k, v, o, dO and lse read, dq, dk, dv written) and the
    device time of each of its passes (the dk/dv pass is
    ``dkdv_wide_kernel`` at D = 192); the launch must take the tensor
    cores.  Then the forward with the lse at the same shape (row 5's
    training entry, on the tensor cores): its time, device time and bound
    (two products over the visible pairs), beside SDPA's forward under
    ``is_causal`` (the same function at this shape: no offset, every key
    valid; row 5's library time) and, causal, under the same mask as a
    boolean tensor.  ``causal=False`` is the audio encoder's attention:
    every key visible to every query."""
    Tq, H, D = q.shape[-3:]
    Tk, Dv = kk.shape[-3], v.shape[-1]
    o, lse = k.flash_attention_kernel(q, kk, v, causal=causal,
                                      return_lse=True)
    args = (q, kk, v, o, do, lse)
    bwd = k.flash_attention_bwd_kernel
    got = _counted(bwd, lambda: bwd(*args, causal=causal), "wgmma")
    grid = dict(bwd.last_grid)
    again = bwd(*args, causal=causal)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "flash bwd at the training shape: two launches differ")
    del again
    want = k.flash_attention_bwd_plain(*args, causal=causal)
    errs = {n: (max_err(torch, x, w), float(w.float().abs().max()),
                int((x != w).sum()), x.numel())
            for n, x, w in zip(("dq", "dk", "dv"), got, want)}
    err = max(e / max(s, 1e-6) for e, s, _, _ in errs.values())
    log(f"flash bwd at the training shape ({grid}): (max |err|, max "
        f"|plain|, elements that differ, elements) {errs}")
    check(err <= 1.6e-2, f"flash bwd at the training shape: rel err {err}")
    del got, want
    n = q.numel() // (Tq * H * D)
    pairs = n * H * _attn_pairs(Tq, causal)
    ops = 2 * pairs * (3 * D + 2 * Dv)
    nbytes = 2 * (2 * q.numel() + 2 * kk.numel() + 2 * v.numel()
                  + 2 * o.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, ops, "bfloat16")

    def call():
        return bwd(*args, causal=causal)

    ms = cuda_ms(torch, call, 5)
    # the device time by pass, each from its own traces, and their sum (one
    # trace of all three has been seen to hold only some of them)
    dkdv = "dkdv_wide_kernel" if D == 192 else "dkdv_tc_kernel"
    passes = {name: device_ms(torch, call, 3, (name,))
              for name in ("bwd_rows_kernel", dkdv, "dq_tc_kernel")}
    dev = None if None in passes.values() else sum(passes.values())
    plain = cuda_ms(torch, lambda: k.flash_attention_bwd_plain(
        *args, causal=causal), 2)
    # the library's yardstick: SDPA's backward alone, on its own forward
    sdpa_bwd = _sdpa_grad(torch, q, kk, v, do, causal=causal)
    library = cuda_ms(torch, sdpa_bwd, 5)
    library_dev = device_ms(torch, sdpa_bwd, 3, ("",))
    library_backend = sdpa_bwd.backend
    del sdpa_bwd
    torch.cuda.empty_cache()
    log(f"flash bwd at q {tuple(q.shape)}, v {tuple(v.shape)}: {ms:.4f} ms "
        f"(device {_ms(dev, 4)}; passes {passes}), plain {plain:.3f}, sdpa "
        f"backward {library:.4f} (device {_ms(library_dev, 4)}; backend "
        f"{library_backend or 'default'}), bound {b_ms:.4f} ms by {b_by}; "
        f"rel err {err:.3g}")
    # the forward with the lse at the same shape (D = 80: the tensor cores)
    def fwd():
        return k.flash_attention_kernel(q, kk, v, causal=causal,
                                        return_lse=True)

    f_route = _attention_route(torch, q.dtype, D, Dv, H // kk.shape[-2])
    check(f_route == "wgmma", f"flash forward at the training shape: "
          f"the rule gives {f_route}")
    f_got, f_lse = _counted(k.flash_attention_kernel, fwd, f_route)
    f_want, f_lse_want = k.flash_attention_plain(q, kk, v, causal=causal,
                                                 return_lse=True)
    f_err = max_err(torch, f_got, f_want) / max(
        float(f_want.float().abs().max()), 1e-6)
    l_err = max_err(torch, f_lse, f_lse_want)
    check(f_err <= 1.6e-2 and l_err <= 1e-4,
          f"flash forward at the training shape: rel err {f_err}, lse err "
          f"{l_err}")
    del f_got, f_lse, f_want, f_lse_want
    f_ms = cuda_ms(torch, fwd, 5)
    # ten calls a trace: traces of the forwards' shorter windows (three
    # calls, under a millisecond) have come back empty late in the script
    f_dev = device_ms(torch, fwd, 10, FLASH_KERNELS)
    f_plain = cuda_ms(torch, lambda: k.flash_attention_plain(
        q, kk, v, causal=causal, return_lse=True), 2)
    f_b_ms, f_b_by = bound(
        2 * (q.numel() + kk.numel() + v.numel() + o.numel())
        + 4 * lse.numel(), 2 * pairs * (D + Dv), "bfloat16")
    sdpa = _sdpa(torch, q, kk, v, None, causal=causal)
    f_lib_backend = sdpa.backend
    f_lib = cuda_ms(torch, sdpa, 5)
    f_lib_dev = device_ms(torch, sdpa, 10, ("",))
    f_mask = f_mask_dev = None
    if causal:
        t_ = torch.arange(Tq, device=q.device)
        visible = (t_[None, :] <= t_[:, None]).expand(n, Tq, Tk)
        sdpa = _sdpa(torch, q, kk, v, visible)
        f_mask = cuda_ms(torch, sdpa, 5)
        f_mask_dev = device_ms(torch, sdpa, 10, ("",))
        del visible
    del sdpa
    log(f"flash forward with the lse at q {tuple(q.shape)} ({f_route}, "
        f"causal {causal}): {f_ms:.4f} ms (device {_ms(f_dev, 4)}), bound "
        f"{f_b_ms:.4f} ms by {f_b_by}, plain {f_plain:.3f}, rel err "
        f"{f_err:.3g}; sdpa forward ({f_lib_backend or 'default'} backend) "
        f"is_causal={causal} {f_lib:.4f} (device "
        f"{_ms(f_lib_dev, 4)}), boolean mask {_ms(f_mask, 4)} (device "
        f"{_ms(f_mask_dev, 4)})")
    out = {"max_abs_err": err, "ms": ms, "device_ms": dev,
           "pass_device_ms": passes, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library,
           "library_device_ms": library_dev, "grid": grid,
           "shape": list(q.shape),
           "forward": {"route": f_route, "max_abs_err": f_err, "ms": f_ms,
                       "device_ms": f_dev, "plain_ms": f_plain,
                       "bound_ms": f_b_ms, "bound_by": f_b_by,
                       "library_ms": f_lib, "library_device_ms": f_lib_dev,
                       "library_mask_ms": f_mask,
                       "library_mask_device_ms": f_mask_dev}}
    if library_backend:
        out["library_backend"] = library_backend
    if f_lib_backend:
        out["forward"]["library_backend"] = f_lib_backend
    return out


def _cut(cfg, layers: int):
    import dataclasses
    return dataclasses.replace(cfg, num_layers=layers)


def _train_setup(torch, dev, cfg, mesh, donate=False, optimizer="adamw",
                 **knobs):
    """A step on ``mesh`` with the checks' constant learning rate, AdamW
    (or ``optimizer="adafactor"``, the launcher's choice at 30e9 parameters
    and more), and the SyntheticLM batches laid out on the card; ``donate``
    updates the parameters and the state in place, as the launcher's loop
    does."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.interop import stack_shards
    from repro_torch.models import api
    from repro_torch.models.config import ParallelCtx
    from repro_torch.train.optim import adafactor, adafactor_dim_axes, adamw
    from repro_torch.train.step import build_train_step

    knobs.setdefault("microbatch", TRAIN_MICRO)
    ctx = ParallelCtx.from_mesh(mesh, remat=True, **knobs)
    lr = lambda step: torch.tensor(TRAIN_LR)  # noqa: E731
    if optimizer == "adafactor":
        opt = adafactor(lr, dim_axes=adafactor_dim_axes(
            cfg, mesh, rules_for_ctx(ctx)), nd=mesh.ndim)
    else:
        opt = adamw(lr, b1=TRAIN_B1)
    step = build_train_step(cfg, mesh, ctx, opt, optimizer_name=optimizer,
                            donate=donate)
    structs, bspecs = api.batch_structs(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ,
                                        dp_axes=ctx.dp_axes)
    src = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=17)

    def batch(i):
        return {n: stack_shards(a, mesh, bspecs[n], device=dev,
                                dtype=structs[n].dtype)
                for n, a in src.batch_at(i).items()}
    return ctx, opt, step, batch


def _step_grads(torch, state, metrics, nd):
    """The reduced gradients a first AdamW step from zero moments applied,
    read back from its first moment: m = (1 - b1) * scale * g, with the
    step's clip scale min(1, 1 / grad_norm)."""
    scale = torch.clamp(1.0 / torch.clamp(metrics["grad_norm"], min=1e-9),
                        max=1.0)
    return {n: m / ((1 - TRAIN_B1)
                    * scale.reshape(*scale.shape, *([1] * (m.dim() - nd))))
            for n, m in state["m"].items()}


def _grads_close(torch, got, want, tol, what, scale=None):
    """Worst error of ``got`` against ``want``, leaf by leaf, relative to
    each leaf's largest |want|, or to ``scale`` (one number, or one a
    leaf) where given; fails above ``tol``."""
    worst = 0.0
    for n in want:
        ref = scale.get(n) if isinstance(scale, dict) else scale
        ref = ref or max(float(want[n].abs().max()), 1e-30)
        rel = max_err(torch, got[n], want[n]) / ref
        worst = max(worst, rel)
        check(rel <= tol, f"{what}: {n} differs by {rel} (bound {tol})")
    return worst


@contextlib.contextmanager
def _counting(cls, verbs):
    """Counts the calls of ``cls``'s own ``verbs`` while the block runs."""
    counts = dict.fromkeys(verbs, 0)
    saved = {v: cls.__dict__[v] for v in verbs}

    def counted(verb, f):
        def call(self, *args, **kwargs):
            counts[verb] += 1
            return f(self, *args, **kwargs)
        return call
    for v in verbs:
        setattr(cls, v, counted(v, saved[v]))
    try:
        yield counts
    finally:
        for v, f in saved.items():
            setattr(cls, v, f)


def train_checks(torch, k, dev) -> dict:
    """At full width, depth cut to TRAIN_CUT_LAYERS, on pod 2 x data 2 x
    model 2: one step on the kernels against the same step on the plain
    versions, the flat backend against the hierarchical one and the int8
    codec against flat (each held by the gradients the step applied, read
    back from its AdamW first moment), and a checkpoint save / restore
    against the uninterrupted run, bit for bit."""
    import os
    import shutil
    from repro_torch import configs
    from repro_torch.core.backends import HierarchicalBackend
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.distributed.buckets import plan_for_config
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    from repro_torch.launch.train import from_global, parse_mesh, to_global
    from repro_torch.models import schema as sch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.step import (opt_state_specs, per_rank_grads,
                                        reduce_gradients)

    cfg = _cut(configs.get(TRAIN_ARCH), TRAIN_CUT_LAYERS)
    mesh = parse_mesh(TRAIN_CHECK_MESH)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(1), device=dev)
    out = {}
    with use_default(dctx):
        ctx, opt, step, batch = _train_setup(torch, dev, cfg, mesh,
                                             dp_backend="flat")
        b0 = batch(0)
        st0 = opt.init(params)
        nd = mesh.ndim
        verbs = ("allreduce", "reducescatter", "allgather")
        # each step from (params, st0) returns new parameters and state
        # (donate=False); all but the applied gradients is dropped at once,
        # since the replicated embedding and head make a state of about
        # 12 GB
        with _counting(HierarchicalBackend, verbs) as hier_flat:
            p, st, met_k = step(params, st0, b0, 0)
        del p
        r_k = _step_grads(torch, st, met_k, nd)
        del st
        # 1. the same step on the plain versions, on the card
        saved = fa_mod.flash_attention_kernel, fa_mod.flash_attention_bwd_kernel
        fa_mod.flash_attention_kernel = fa_mod.flash_attention_plain
        fa_mod.flash_attention_bwd_kernel = fa_mod.flash_attention_bwd_plain
        try:
            p, st, met_p = step(params, st0, b0, 0)
            del p
            r_p = _step_grads(torch, st, met_p, nd)
            del st
            l_p, g_p = per_rank_grads(params, b0, cfg, ctx, mesh)
        finally:
            fa_mod.flash_attention_kernel, fa_mod.flash_attention_bwd_kernel \
                = saved
        l_k, g_k = per_rank_grads(params, b0, cfg, ctx, mesh)
        loss_err = max_err(torch, l_k, l_p) / float(l_p.abs().max())
        g_scale = {n: max(float(g_p[n].float().abs().max()), 1e-30)
                   for n in g_p}
        g_err = max(max_err(torch, g_k[n], g_p[n]) / g_scale[n] for n in g_p)
        # bf16 activations and weights: 2e-2 of each leaf's largest
        # per-rank gradient, the reference's own bf16 bound for the model
        # stack; the step's reduced gradients are means of those
        check(loss_err <= 1e-3 and g_err <= 2e-2,
              f"train: kernels vs plain loss {loss_err}, grads {g_err}")
        out["kernels_vs_plain"] = {
            "loss_rel": loss_err, "grad_rel": g_err,
            "step_grad_rel": _grads_close(torch, r_k, r_p, 2e-2,
                                          "train: kernels vs plain step",
                                          scale=g_scale)}
        del r_p, g_p
        # 2. flat vs hierarchical (the (pod, data) buckets), int8 vs flat
        ctx_h, _, step_h, _ = _train_setup(torch, dev, cfg, mesh,
                                           dp_backend="hierarchical")
        with _counting(HierarchicalBackend, verbs) as hier:
            p, st, met_h = step_h(params, st0, b0, 0)
        del p
        r_h = _step_grads(torch, st, met_h, nd)
        del st
        # the overlapped path: each (pod, data) bucket reduce-scatters a
        # microbatch and all-gathers once, through the hierarchical
        # algorithm; the flat step never reaches it
        n_pd = sum(b.axes == ("pod", "data")
                   for b in plan_for_config(cfg, mesh, ctx_h).buckets)
        want = {"allreduce": 0, "reducescatter": TRAIN_MICRO * n_pd,
                "allgather": n_pd}
        check(n_pd > 0 and hier == want
              and hier_flat == dict.fromkeys(verbs, 0),
              f"train: hierarchical calls {hier} (want {want}), "
              f"{hier_flat} in the flat step")
        check(torch.equal(met_h["loss"], met_k["loss"]),
              "train: the loss moved with the backend")
        out["flat_vs_hierarchical"] = {
            "hierarchical_calls": hier,
            "grad_norm_rel": float((met_h["grad_norm"] - met_k["grad_norm"])
                                   .abs().max() / met_k["grad_norm"].max()),
            "step_grad_rel": _grads_close(torch, r_h, r_k, 2 ** -8,
                                          "train: hierarchical vs flat")}
        del r_h
        ctx_q, _, _, _ = _train_setup(torch, dev, cfg, mesh,
                                      grad_codec="int8")
        r_f, _ = reduce_gradients(g_k, cfg, ctx, mesh=mesh)
        r_q, _ = reduce_gradients(g_k, cfg, ctx_q, mesh=mesh)
        # each reduced entry carries two int8 roundings of at most half a
        # quantization step, amax / 127 of its block: within 2/127 of the
        # largest per-rank gradient of any bucket
        g_max = max(float(g_k[n].float().abs().max()) for n in r_f)
        q_err = max(max_err(torch, r_q[n], r_f[n]) for n in r_f) / g_max
        check(q_err <= 2 / 127, f"train: int8 vs flat reduce {q_err}")
        del r_f, r_q
        _, _, step_q, _ = _train_setup(torch, dev, cfg, mesh,
                                       grad_codec="int8")
        p, st, met_q = step_q(params, st0, b0, 0)
        del p
        r_q = _step_grads(torch, st, met_q, nd)
        del st
        out["int8_vs_flat"] = {
            "reduce_rel": q_err,
            "step_grad_rel": _grads_close(torch, r_q, r_k, 2 / 127,
                                          "train: int8 vs flat step",
                                          scale=g_max)}
        del r_q, r_k, g_k
        # 3. save at step 2, restore, step 3 == the uninterrupted run
        ckdir = ROOT / "build" / "chip_smoke_ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        mgr = CheckpointManager(str(ckdir))
        pspecs = sch.partition_specs(cfg, mesh)
        ospecs = opt_state_specs(cfg, mesh, "adamw")
        p, st = params, st0
        del params, st0
        for i in range(2):
            p, st, _ = step(p, st, batch(i), i)
        saved = (to_global(p, pspecs, mesh), to_global(st, ospecs, mesh))
        mgr.save(2, *saved, blocking=True)
        check(mgr.verify_step(2) and mgr.latest() == 2,
              "train: checkpoint 2 not verified")
        p_a, st_a, _ = step(p, st, batch(2), 2)
        s, gp, gs, _ = mgr.restore()
        p_r = from_global(gp, pspecs, mesh, dev)
        check(s == 2 and all(torch.equal(p_r[n], p[n]) for n in p)
              and all(torch.equal(gs[m][n], saved[1][m][n])
                      for m in gs for n in gs[m]),
              "train: the restored state differs from the saved one")
        del p, st, gp, saved
        st_r = from_global(gs, ospecs, mesh, dev)
        del gs
        p_b, st_b, _ = step(p_r, st_r, batch(2), 2)
        same = all(torch.equal(p_a[n], p_b[n]) for n in p_a) and all(
            torch.equal(st_a[m][n], st_b[m][n]) for m in st_a for n in p_a)
        check(same, "train: step 3 after restore differs from the run")
        out["checkpoint_restore_bitwise"] = same
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir.parent, exist_ok=True)
    log("train checks: " + json.dumps(out))
    return out


def _train_breakdown(torch, dev, cfg, run) -> str:
    """One more step on the launcher's final state, under the profiler:
    the device time by kernel group and the busy share (the state is
    donated to the step, as the launcher's loop does)."""
    from repro_torch.core.context import use_default
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.interop import stack_shards
    from repro_torch.models import api
    from repro_torch.models.config import ParallelCtx
    from repro_torch.train.optim import adamw
    from repro_torch.train.step import build_train_step

    mesh = run["mesh"]
    ctx = ParallelCtx.from_mesh(mesh, remat=True, microbatch=TRAIN_MICRO)
    with use_default(run["context"]):
        step = build_train_step(cfg, mesh, ctx,
                                adamw(lambda s: torch.tensor(TRAIN_LR)))
    _, bspecs = api.batch_structs(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ,
                                  dp_axes=ctx.dp_axes)
    batch = {n: stack_shards(a, mesh, bspecs[n], device=dev) for n, a in
             SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=17)
             .batch_at(TRAIN_STEPS).items()}
    state = [run["params"], run["opt_state"]]

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch, TRAIN_STEPS)

    with use_default(run["context"]):
        text = _breakdown(torch, one, reps=1)
    log(f"train: one step profiled: {text}")
    return text


def train_phase(torch, k, dev, wrappers) -> dict:
    """stablelm-3b at full width and depth trained TRAIN_STEPS steps
    through the port's launcher on data 2 x model 2, every attention's
    forward and backward counted; then the depth-cut checks and the
    backward kernel's timings.  Returns the backward kernel's line of the
    ``kernels`` JSON (and the flash forward's training counts)."""
    from repro_torch import configs
    from repro_torch.launch import train as launcher

    cfg = configs.get(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatch",
            str(TRAIN_MICRO), "--mesh", TRAIN_MESH, "--device",
            str(torch.device(dev).type)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(wrappers)
    t0 = time.perf_counter()
    run = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = wrappers["flash_attention"], wrappers["flash_attention_bwd"]
    counts = {"forward": fwd.launches, "forward_routes": dict(
        fwd.route_launches), "backward": bwd.launches,
        "backward_routes": dict(bwd.route_launches)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_pass = cfg.num_layers * TRAIN_MICRO * TRAIN_STEPS
    log(f"train: {cfg.name} ({cfg.param_count()} parameters) on "
        f"{TRAIN_MESH}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens (microbatch {TRAIN_MICRO}) in {wall:.1f} s; losses "
        f"{run['losses']}, grad norms {run['grad_norms']}; flash launches "
        f"{counts}; peak {peak:.2f} GB")
    check(all(math.isfinite(x) for x in run["losses"] + run["grad_norms"])
          and len(run["losses"]) == TRAIN_STEPS, "train: a non-finite step")
    # every layer's attention: a forward and a remat forward, one backward,
    # a microbatch a step; stablelm's head_dim 80 is on both rules (D a
    # multiple of 16 up to 128), so every launch takes the tensor cores
    check(counts["forward"] == 2 * per_pass
          and counts["forward_routes"] == {"simt": 0, "wgmma": 2 * per_pass}
          and counts["backward"] == per_pass
          and counts["backward_routes"] == {"simt": 0, "wgmma": per_pass},
          f"train: flash launches {counts}, not {2 * per_pass} forward and "
          f"{per_pass} backward, all on wgmma")
    b_ms = _train_flops(cfg, tokens) / PEAK_OPS["bfloat16"] * 1e3
    steps = [{"ms": s * 1e3, "tokens_per_s": tokens / s}
             for s in run["step_s"]]
    log(f"train: step times (ms, the first with its kernel builds) "
        f"{[round(s['ms'], 2) for s in steps]}, tokens/s "
        f"{[round(s['tokens_per_s'], 1) for s in steps]}; bound "
        f"{b_ms:.2f} ms a step ({_train_flops(cfg, tokens):.4g} operations "
        f"at the bf16 tensor-core rate)")
    breakdown = _train_breakdown(torch, dev, cfg, run)
    del run
    torch.cuda.empty_cache()
    checks = train_checks(torch, k, dev)
    torch.cuda.empty_cache()
    # the backward kernel at one layer's attention of the training path:
    # (ranks 2 x 2, a microbatch of 2, 1024 tokens, 16 heads of 80) bf16
    g = torch.Generator(device=dev).manual_seed(3)
    H_loc = cfg.num_heads // 2
    shape = (2, 2, TRAIN_BATCH // 2 // TRAIN_MICRO, TRAIN_SEQ, H_loc,
             cfg.head_dim)
    q, kk, v, do = (torch.randn(*shape, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(4))
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:125 "
                       "(the gradient of its forward)",
           "launches": counts["backward"],
           "route_launches": counts["backward_routes"]}
    row.update(_bwd_at(torch, k, q, kk, v, do))
    row["train"] = {"step_ms": steps, "bound_ms": b_ms,
                    "peak_memory_gb": peak, "flash_forward": counts,
                    "breakdown": breakdown, "checks": checks}
    del q, kk, v, do
    torch.cuda.empty_cache()
    return row


# -- training the recurrent families: the scan's backward (row 11) ------------

# zamba2-1.2b at full width and depth through the launcher; rwkv6-7b at full
# width with its depth cut to REC_TRAIN_LAYERS of 32 (the whole model's
# 7.53e9 parameters and their AdamW state, about 160 GB, do not fit one
# card); both on TRAIN_MESH with the training phase's traffic.  The checks'
# depth: rwkv6 2 layers, zamba2 6 (one application of the shared block)
REC_TRAIN_LAYERS = {"zamba2-1-2b": None, "rwkv6-7b": 8}
REC_CHECK_LAYERS = {"zamba2-1-2b": 6, "rwkv6-7b": 2}


class _PlainScanFn:
    """``LinearScanFn``'s stand-in for the checks: the plain scan on the
    card, differentiated by autograd."""

    @staticmethod
    def apply(p, q, log_a, r, s0, readout_pre, chunk):
        import torch
        from repro_torch.kernels.linear_scan.kernel import linear_scan_plain
        return linear_scan_plain(p, q, torch.exp(log_a), r, s0,
                                 readout_pre=readout_pre)


def _scan_bwd_work(BH, T, M, N, pre, chunk=16):
    """(bytes, f32 operations) of one backward call: p, q, a, r and dy read
    once, dp, dq, dla and dr written once (s0 and ds_fin absent, as in
    training); the products of its chunked form, 2 a multiply-add: over the
    visible pairs of each chunk P, A, Aᵀ dy and the pair terms of dr and dq
    (2M, 2N, 2M, 2N, 2N a pair); 2MN a row for each of the state pass,
    dp's, dr's and dq's state terms and the carried cotangent, and 2MN a
    chunk for Σ K ⊙ S_start; and dla's terms (2N each: the K terms of dq
    before t, the S_start terms of dr at or after t, the pairs straddling
    t)."""
    nbytes = 4 * BH * T * (3 * M + 6 * N)
    ops = 0
    for c0 in range(0, T, chunk):
        c = min(chunk, T - c0)
        rho = [u - 1 if pre else u for u in range(c)]
        vis = sum(1 for u in range(c) for s in range(c) if s <= rho[u])
        reads = [sum(1 for u in range(c) if rho[u] >= t) for t in range(c)]
        dla = sum(t + reads[t] + t * reads[t] for t in range(c))
        ops += vis * (4 * M + 6 * N) + 5 * 2 * c * M * N + 2 * M * N \
            + 2 * N * dla
    return nbytes, BH * ops


def _scan_bwd_design(BH, T, pre):
    """What ``csrc/linear_scan_bwd.cu`` itself computes for one call, at its
    padded width D = 64: (f32 operations, exponentials).  Operations, 2 a
    multiply-add: pass 1's state update (2 C D² a chunk but the last);
    in pass 2 a chunk's dense products (dp's K term, drS, dqK and K's
    update, 2 C D² each; P and dp's A term over whole 32 x 32 blocks, 2 C²
    D each; A's off block and the off-block terms of dr and dq, 2 x 16² D
    each; Σ K ⊙ S_start, 2 D²) and per visible pair of the two diagonal
    blocks and channel 3 for A's entry and 8 for the pair terms of dr, dq
    and dla.  Exponentials: the logs of both passes, the tables, the
    products' scales, A's per strict pair (s < u) and channel, the pair
    terms' per visible pair and channel."""
    C, D, sub = 32, 64, 16
    nc = -(-T // C)
    strict = 2 * (sub * (sub - 1) // 2)
    pairs = strict if pre else strict + 2 * sub
    chunk = (8 * C * D * D + 4 * C * C * D + 6 * sub * sub * D + 2 * D * D
             + 11 * pairs * D)
    ops = (nc - 1) * 2 * C * D * D + nc * chunk
    exps = (nc - 1) * 2 * C * D + nc * (C * D * 6 + 2 * sub * D + D
                                        + (strict + pairs) * D)
    return BH * ops, BH * exps


def _ptxas_of(lib: str, kernel: str) -> str:
    """Registers and spills of ``kernel``'s instances in the build log of
    ``lib`` (``build/repro_torch/lib<lib>.log``, written by the build)."""
    from repro_torch.kernels import _build
    path = _build.BUILD_DIR / f"lib{lib}.log"
    if not path.exists():
        return "registers not in this run's build log"
    found = [f"{func}: {regs} registers, {spills}" for func, regs, spills
             in ptxas_summary(path.read_text()) if kernel in func]
    return "; ".join(found) or "registers not in this run's build log"


def _scan_bwd_at(torch, k, g, BH, pre):
    """Row 11 at the training shape (BH sequences of TRAIN_SEQ rows, M = N
    = 64: a layer's call in both recurrent models) against its plain
    version within 2e-4 of each gradient's scale, run twice for equal bits,
    with
    a row of decays below 1e-38 (finite, dla 0 there, within the same
    bound), and timed: CUDA events, the profiler's device time, its bound
    and the plain version's time."""
    T, M, N = TRAIN_SEQ, 64, 64
    p, q, a, r = _scan_inputs(torch, g, BH, T, M, N, None)
    dy = torch.randn(BH, T, M, generator=g, device=p.device)
    kern = k.linear_scan_bwd_kernel
    args = (p, q, a, r, None, dy, None)
    got = kern(*args, readout_pre=pre)
    want = k.linear_scan_bwd_plain(*args, readout_pre=pre)
    err = _scan_bwd_err(torch, got, want)
    abs_err = max(max_err(torch, x, w) for x, w in zip(got, want))
    again = kern(*args, readout_pre=pre)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    check(all(bool(torch.isfinite(t).all()) for t in got) and err <= 2e-4
          and same, f"linear_scan_bwd at the training shape (pre {pre}): "
          f"relative err {err:.3g}, repeatable {same}")
    del got, want, again
    at = a.clone()
    at[:, T // 3, :8] = 0.0
    at[:, 2 * T // 3, :8] = 1e-40
    t_args = (p, q, at, r, None, dy, None)
    got = kern(*t_args, readout_pre=pre)
    want = k.linear_scan_bwd_plain(*t_args, readout_pre=pre)
    t_err = _scan_bwd_err(torch, got, want)
    check(all(bool(torch.isfinite(t).all()) for t in got) and t_err <= 2e-4
          and not bool(got[2][:, T // 3, :8].any())
          and not bool(got[2][:, 2 * T // 3, :8].any()),
          f"linear_scan_bwd with decays below 1e-38: relative err "
          f"{t_err:.3g}")
    del got, want, at, t_args
    nbytes, ops = _scan_bwd_work(BH, T, M, N, pre)
    b_ms, b_by = bound(nbytes, ops, "float32")
    d_ops, d_exps = _scan_bwd_design(BH, T, pre)
    smem = k.scan_bwd_smem_bytes()
    regs = _ptxas_of("linear_scan_bwd", "scan_bwd_kernel")

    def call():
        return kern(*args, readout_pre=pre)

    ms = cuda_ms(torch, call, 5)
    # one launch a call, back to back: its device time lies inside the
    # events' time and close under it; a reading that does not is read
    # again (the profiler has returned one under half the events' time)
    for _ in range(3):
        dev_ms = device_ms(torch, call, 10, SCAN_BWD_KERNELS)
        if dev_ms is not None and 0.8 * ms <= dev_ms <= 1.1 * ms:
            break
        log(f"linear_scan_bwd: device time {_ms(dev_ms, 4)} ms against "
            f"{ms:.4f} ms by events; read again")
    check(dev_ms is not None and 0.8 * ms <= dev_ms <= 1.1 * ms,
          f"linear_scan_bwd at the training shape (pre {pre}): device time "
          f"{_ms(dev_ms, 4)} ms against {ms:.4f} ms by events")
    plain = cuda_ms(torch, lambda: k.linear_scan_bwd_plain(
        *args, readout_pre=pre), 1)
    log(f"linear_scan_bwd at BH {BH}, T {T}, M {M}, N {N} (pre {pre}): "
        f"{ms:.4f} ms (device {_ms(dev_ms, 4)}), plain {plain:.2f}, bound "
        f"{b_ms:.4f} ms by {b_by} ({ops:.4g} operations); the design "
        f"{d_ops:.4g} operations ({d_ops / PEAK_OPS['float32'] * 1e3:.4f} ms "
        f"at the f32 rate) and {d_exps:.4g} exponentials, {smem} bytes of "
        f"shared memory a block, {k.BWD_BLOCKS_PER_SM} block an SM; {regs}; "
        f"err {abs_err:.4g} (relative {err:.3g}), bitwise repeatable {same}; "
        f"decays below 1e-38: relative err {t_err:.3g}")
    return {"max_abs_err": abs_err, "rel_err": err, "tiny_rel_err": t_err,
            "bitwise_repeatable": same, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [BH, T, M, N], "readout_pre": pre}


def _rec_train_checks(torch, k, dev, arch) -> dict:
    """At full width, depth cut to REC_CHECK_LAYERS, on TRAIN_MESH, with
    f32 weights: each rank's loss and gradients on the kernels (the scan
    and its backward; zamba2's flash and its gradient) against the same on
    their plain versions, on the card, from one microbatch of the phase's
    traffic.  Bounds: the loss within 1e-5 and each gradient leaf within
    5e-3 of its largest per-rank value: f32 sums in another order, which
    the embedding table's gradient amplifies (each token's row sums every
    position's contribution, most of which cancels): on the CPU at full
    width and T = 256 the chunked emulation of both scan kernels holds
    zamba2's depth-6 and rwkv6's depth-2 gradients within 7e-5 and 1e-4
    of the plain scan's, the table's the largest; on the card at T = 1024
    rwkv6's table differed by 1.2e-3, zamba2's worst leaf by 1.7e-4.  In bf16
    these random-weight models' gradients are chaotic: the same two runs,
    whose scans agree within 1e-7, differ by up to 30 % of a leaf's scale
    in bf16 (on the CPU), so bf16 would hold nothing here."""
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import schema as sch
    from repro_torch.train.step import per_rank_grads

    cfg = _cut(configs.get(arch), REC_CHECK_LAYERS[arch])
    mesh = parse_mesh(TRAIN_MESH)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    params = {n: p.float() for n, p in sch.init_params(
        cfg, mesh, torch.Generator(device=dev).manual_seed(1),
        device=dev).items()}
    wr = (k.linear_scan_kernel, k.linear_scan_bwd_kernel,
          k.flash_attention_kernel, k.flash_attention_bwd_kernel)
    with use_default(dctx):
        ctx, _, _, batch = _train_setup(torch, dev, cfg, mesh)
        # one microbatch of the phase's traffic: the training path's shapes
        b0 = {n: t.narrow(mesh.ndim, 0, t.shape[mesh.ndim] // TRAIN_MICRO)
              for n, t in batch(0).items()}
        before = [w.launches for w in wr]
        l_k, g_k = per_rank_grads(params, b0, cfg, ctx, mesh)
        launched = [w.launches - b for w, b in zip(wr, before)]
        with _Swap(ls_ops, "LinearScanFn", _PlainScanFn), \
                _Swap(fa_mod, "flash_attention_kernel",
                      fa_mod.flash_attention_plain), \
                _Swap(fa_mod, "flash_attention_bwd_kernel",
                      fa_mod.flash_attention_bwd_plain):
            before = [w.launches for w in wr]
            l_p, g_p = per_rank_grads(params, b0, cfg, ctx, mesh)
            plain_launched = [w.launches - b for w, b in zip(wr, before)]
    del params
    L = cfg.num_layers
    n_app = L // cfg.attn_every if cfg.family == "hybrid" else 0
    check(launched == [2 * L, L, 2 * n_app, n_app] and plain_launched
          == [0, 0, 0, 0], f"{arch} checks: launches (scan, scan backward, "
          f"flash, flash backward) {launched} on the kernels, "
          f"{plain_launched} on the plain versions")
    loss_err = max_err(torch, l_k, l_p) / float(l_p.abs().max())
    scale = {n: max(float(g_p[n].float().abs().max()), 1e-30) for n in g_p}
    errs = sorted(((max_err(torch, g_k[n], g_p[n]) / scale[n], n)
                   for n in g_p), reverse=True)
    worst = errs[0]
    out = {"layers": L, "loss_rel": loss_err, "grad_rel": worst[0],
           "grad_rel_leaf": worst[1], "grad_rel_top": errs[:4],
           "loss": float(l_k.mean())}
    log(f"{arch} checks at depth {L}: kernels vs plain " + json.dumps(out))
    check(loss_err <= 1e-5 and worst[0] <= 5e-3,
          f"{arch}: kernels vs plain loss {loss_err}, grads {worst}")
    del g_k, g_p
    torch.cuda.empty_cache()
    return out


def recurrent_train_phase(torch, k, dev, wrappers, arch) -> dict:
    """``arch`` trained TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
    (microbatch TRAIN_MICRO) on TRAIN_MESH: zamba2-1.2b at full width and
    depth through the port's launcher, rwkv6-7b at full width with its
    depth cut to REC_TRAIN_LAYERS through ``_train_setup`` (AdamW at the
    checks' constant rate, the state updated in place).  Every wrapper's
    count is zeroed just before the steps and read just after: every scan
    forward and remat forward on the scan kernel's prefill route, every
    scan backward on row 11, zamba2's shared attention (forward and remat
    forward, backward) on rows 5 and 10 on the tensor cores, nothing else.
    Then one more step profiled by kernel group, and the depth-cut checks.
    Returns the phase's numbers."""
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.launch import train as launcher
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import schema as sch

    layers = REC_TRAIN_LAYERS[arch]
    cfg = configs.get(arch) if layers is None else _cut(configs.get(arch),
                                                        layers)
    tag = f"train {arch}"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if layers is None:
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatch",
                str(TRAIN_MICRO), "--mesh", TRAIN_MESH, "--device",
                str(torch.device(dev).type)]
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        run = launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        routes = {n: dict(wrappers[n].route_launches) for n in (
            "linear_scan", "linear_scan_bwd", "flash_attention",
            "flash_attention_bwd")}
        losses, norms, step_s = run["losses"], run["grad_norms"], \
            run["step_s"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        breakdown = _train_breakdown(torch, dev, cfg, run)
        del run
    else:
        mesh = parse_mesh(TRAIN_MESH)
        dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
        with use_default(dctx):
            _, opt, step, batch = _train_setup(torch, dev, cfg, mesh,
                                               donate=True)
            state = [sch.init_params(cfg, mesh, torch.Generator(device=dev)
                                     .manual_seed(0), device=dev)]
            state.append(opt.init(state[0]))
            losses, norms, step_s = [], [], []
            _zero_counts(wrappers)
            t0 = time.perf_counter()
            for i in range(TRAIN_STEPS):
                t1 = time.perf_counter()
                state[0], state[1], met = step(state[0], state[1], batch(i),
                                               i)
                losses.append(float(met["loss"].reshape(-1)[0]))
                norms.append(float(met["grad_norm"].reshape(-1)[0]))
                step_s.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: w.launches for n, w in wrappers.items()}
            routes = {n: dict(wrappers[n].route_launches) for n in (
                "linear_scan", "linear_scan_bwd", "flash_attention",
                "flash_attention_bwd")}
            peak = torch.cuda.max_memory_allocated() / 1e9
            extra = batch(TRAIN_STEPS)

            def one():
                state[0], state[1], _ = step(state[0], state[1], extra,
                                             TRAIN_STEPS)

            breakdown = _breakdown(torch, one, reps=1)
            log(f"{tag}: one step profiled: {breakdown}")
        del state, extra
    torch.cuda.empty_cache()
    L = cfg.num_layers
    n_app = L // cfg.attn_every if cfg.family == "hybrid" else 0
    passes = TRAIN_MICRO * TRAIN_STEPS
    log(f"{tag}: {cfg.name} ({cfg.param_count()} parameters, {L} layers) "
        f"on {TRAIN_MESH}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens (microbatch {TRAIN_MICRO}) in {wall:.1f} s; "
        f"losses {losses}, grad norms {norms}; launches {launches}, routes "
        f"{routes}; peak {peak:.2f} GB")
    check(all(math.isfinite(x) for x in losses + norms)
          and len(losses) == TRAIN_STEPS, f"{tag}: a non-finite step")
    # each layer's scan: a forward and a remat forward on the prefill route
    # and one backward a microbatch; zamba2's shared block the same on the
    # attention kernels (head_dim 64, G = 1: the tensor cores on both)
    want = {"linear_scan": 2 * L * passes, "linear_scan_bwd": L * passes,
            "flash_attention": 2 * n_app * passes,
            "flash_attention_bwd": n_app * passes}
    check(all(launches[n] == c for n, c in want.items())
          and all(c == 0 for n, c in launches.items() if n not in want),
          f"{tag}: launches {launches}, not {want}")
    check(routes["linear_scan"] == {"prefill": 2 * L * passes, "decode": 0}
          and routes["linear_scan_bwd"] == {"chunked": L * passes}
          and routes["flash_attention"] == {"simt": 0,
                                            "wgmma": 2 * n_app * passes}
          and routes["flash_attention_bwd"] == {"simt": 0,
                                                "wgmma": n_app * passes},
          f"{tag}: routes {routes}")
    b_ms = _train_flops(cfg, tokens) / PEAK_OPS["bfloat16"] * 1e3
    steps = [{"ms": s * 1e3, "tokens_per_s": tokens / s} for s in step_s]
    log(f"{tag}: step times (ms, the first with its warm-up) "
        f"{[round(s['ms'], 2) for s in steps]}, tokens/s "
        f"{[round(s['tokens_per_s'], 1) for s in steps]}; bound "
        f"{b_ms:.2f} ms a step ({_train_flops(cfg, tokens):.4g} operations "
        f"at the bf16 tensor-core rate)")
    checks = _rec_train_checks(torch, k, dev, arch)
    return {"arch": arch, "layers": L, "parameters": cfg.param_count(),
            "step_ms": steps, "bound_ms": b_ms, "peak_memory_gb": peak,
            "losses": losses, "launches": {n: launches[n] for n in want},
            "routes": routes, "breakdown": breakdown, "checks": checks}


# -- training qwen3-moe: the expert MLP's and the fused dispatch's gradients -

# qwen3-moe-235b-a22b at full width (d 4096, 64 heads of 128 over 4 kv
# heads, 128 experts, top-8, moe_d_ff 1536, vocab 151936) on TRAIN_MESH with
# the training phase's traffic, its depth cut to MOE_TRAIN_LAYERS of 94:
# one layer holds 2.49e9 parameters; depth 1 stacks 10.0 GB of bf16 over
# the four ranks (the embedding and head 2.5 GB of it), depth 2 15.0 GB, and
# a step holds about six times its parameters' bytes (the f32 gradient
# buffers, their reduction and the update; stablelm-3b's step: 57 GB with
# 22 GB of AdamW state for 5.6 GB of parameters), so depth 2's step does
# not fit the card's 80 GB and depth 1's does.  Adafactor, the launcher's
# choice at the full model's size.  MOE_FUSED_STEPS more steps under
# dispatch_impl="fused" at the same depth and tokens, in MOE_FUSED_MICRO
# microbatches a step, as the a2a steps: the dropless ring's worst-case
# plan (caps = t_loc) at microbatch 2 (1024-row blocks of 0.54 GB) holds 17
# GB of blocks, slots and returns for a layer's forward; its backward
# packs the live rows (1.25 GB of scratch there, where padded blocks,
# slots and scratch took about 23 GB and ran out of memory), so the fused
# step fits beside what the a2a step leaves.  The checks' depth: 1, in
# f32; the fused check's tokens: one sequence a data rank, cut to
# MOE_CHECK_SEQ (its f32 blocks, slots and the CUDA-core backward's padded
# scratch beside the f32 parameters and gradients).
MOE_TRAIN_ARCH = "qwen3-moe-235b-a22b"
MOE_TRAIN_LAYERS = 1
MOE_FUSED_STEPS = 2
MOE_FUSED_MICRO = 2
MOE_CHECK_SEQ = 256


@contextlib.contextmanager
def _calls_of(pairs):
    """Counts the calls of each ``(module, name)`` function while the block
    runs (the plain versions a path must not reach)."""
    counts, saved = {}, []
    for mod, name in pairs:
        fn = getattr(mod, name)
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        counts[key] = 0

        def counted(*args, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*args, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _plain_pairs():
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    from repro_torch.kernels.moe_dispatch import fused
    from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
    return ((mlp_mod, "expert_mlp_plain"), (mlp_mod, "expert_mlp_bwd_plain"),
            (fused, "fused_moe_dispatch_plain"),
            (fused, "fused_dispatch_blocks_plain"),
            (fused, "fused_dispatch_bwd_plain"),
            (fa_mod, "flash_attention_plain"),
            (fa_mod, "flash_attention_bwd_plain"))


def _moe_steps(torch, dev, wrappers, cfg, steps, taps=(), profile=True,
               **knobs):
    """``steps`` steps of the MoE config on TRAIN_MESH (Adafactor at the
    checks' constant rate, the state updated in place, the parameters laid
    out by the knobs' rules), every count zeroed just before and read just
    after; each of ``taps`` (module, name, keep) routes the last step's
    calls of one function through ``keep`` (which copies what it needs and
    keeps no call).  Then, with ``profile``, one more step profiled by
    kernel group.  Returns the run's numbers."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import schema as sch

    mesh = parse_mesh(TRAIN_MESH)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "moe_dropped": [],
           "moe_drop_rate": [], "step_s": []}
    with use_default(dctx):
        ctx, opt, step, batch = _train_setup(
            torch, dev, cfg, mesh, donate=True, optimizer="adafactor",
            **knobs)
        state = [sch.init_params(cfg, mesh, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev,
                                 rules=rules_for_ctx(ctx))]
        state.append(opt.init(state[0]))
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        with _calls_of(_plain_pairs()) as plain:
            for i in range(steps):
                t1 = time.perf_counter()
                with contextlib.ExitStack() as stack:
                    if i == steps - 1:
                        for tap in taps:
                            stack.enter_context(_Tap(*tap))
                    state[0], state[1], met = step(state[0], state[1],
                                                   batch(i), i)
                for key, into in (("loss", "losses"),
                                  ("grad_norm", "grad_norms"),
                                  ("moe_dropped", "moe_dropped"),
                                  ("moe_drop_rate", "moe_drop_rate")):
                    out[into].append(float(met[key].reshape(-1)[0]))
                out["step_s"].append(time.perf_counter() - t1)
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = {n: w.launches for n, w in wrappers.items()}
        out["routes"] = {n: dict(w.route_launches) for n, w in
                         wrappers.items() if hasattr(w, "route_launches")
                         and w.launches}
        out["plain_calls"] = dict(plain)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["breakdown"] = None
        if profile:
            extra = batch(steps)

            def one():
                state[0], state[1], _ = step(state[0], state[1], extra,
                                             steps)

            out["breakdown"] = _breakdown(torch, one, reps=1)
    del state
    torch.cuda.empty_cache()
    return out


def _tiles_by_set(torch, rows) -> dict:
    """How many weight sets pack into each number of 64-row tiles, from
    each set's live rows (a tensor)."""
    tiles = ((rows.flatten().long() + 63) // 64).tolist()
    return {n: tiles.count(n) for n in sorted(set(tiles))}


def _expert_bwd_at(torch, k, g, x, dy, counts, f=None):
    """Row 12 at a training call's shape and live rows (``x``, ``dy`` and
    ``counts`` of the call; weights random at its shapes, ``f`` the
    expert width, qwen3-moe's by default) against its plain
    version, twice for equal bits, timed by CUDA events and by the
    profiler's device time (whole and by pass), beside its bound (the live
    rows of x and dy and the weights read once, dx and each dW written
    once; 16 d f operations a live row)."""
    # the call's (*mesh, sources, E, C, d) with the mesh dims folded
    x, dy = (t.reshape(-1, *t.shape[-4:]) for t in (x, dy))
    G, S_, E, C, d = x.shape
    counts = counts.reshape(G, S_, E)
    f = TRAIN_MOE_F if f is None else f
    ws = [(torch.randn(G, E, a, b, generator=g, device="cuda") * a ** -0.5)
          .to(x.dtype) for a, b in ((d, f), (d, f), (f, d))]
    bwd = k.expert_mlp_bwd
    want = k.expert_mlp_bwd_plain(x, *ws, dy, counts)
    torch.cuda.empty_cache()
    got = _counted(bwd, lambda: bwd(x, *ws, dy, counts), "wgmma")
    worst = _bwd_close(torch, got, want, bwd(x, *ws, dy, counts), 1.6e-2,
                       f"expert_mlp_bwd at the training call {tuple(x.shape)}")
    del got, want
    live = int(counts.sum())
    isz = x.element_size()
    nbytes = isz * (2 * live * d + x.numel()
                    + 2 * sum(w.numel() for w in ws))
    ops = 16 * d * f * live
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    fn = lambda: bwd(x, *ws, dy, counts)  # noqa: E731
    row = {"shape": list(x.shape), "f": f, "live_rows": live,
           "max_abs_err": worst, "ms": cuda_ms(torch, fn, 3),
           "device_ms": device_ms(torch, fn, 3, EXPERT_BWD_KERNELS),
           "device_ms_by_kernel": {n: device_ms(torch, fn, 3, (n,))
                                   for n in EXPERT_BWD_KERNELS[1:]},
           "plain_ms": cuda_ms(torch, lambda: k.expert_mlp_bwd_plain(
               x, *ws, dy, counts), 2),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    row["sets_by_tiles"] = _tiles_by_set(torch, counts.sum(1))
    log(f"expert_mlp_bwd at the training call {tuple(x.shape)}, f {f}, "
        f"{live} live rows (weight sets by packed tiles "
        f"{row['sets_by_tiles']}): {row['ms']:.3f} ms (device "
        f"{_ms(row['device_ms'], 3)}; by kernel "
        f"{row['device_ms_by_kernel']}), plain {row['plain_ms']:.3f}, bound "
        f"{b_ms:.3f} ms by {b_by}, rel err {worst:.3g}")
    return row


def _dispatch_bwd_at(torch, k, g, dctx, counts, plan, group, shape, f=None):
    """Row 13 at a training call's plan and live rows (its ``counts``;
    blocks and cotangents random below the counts, zero past them, weights
    random, at the call's shapes; ``f`` the expert width, qwen3-moe's by
    default) against its plain version (run
    MLA_PLAIN_EXPERTS experts at a time), twice for equal bits, timed,
    beside its bound (the live rows of the blocks and cotangents and the
    weights read once, dbuf and each dW written once; 16 d f operations a
    live row)."""
    from repro_torch.core.context import use_default
    lead = tuple(counts.shape[:-1])            # (*mesh, ep)
    E_loc, C, d = plan.E_loc, plan.cap_pad, shape[-1]
    f = TRAIN_MOE_F if f is None else f
    live = (torch.arange(C, device="cuda") < counts[..., None])[..., None]
    buf = (torch.randn(*lead, E_loc, C, d, generator=g, device="cuda")
           * live).to(torch.bfloat16)
    dfull = (torch.randn(*lead, E_loc, C, d, generator=g, device="cuda")
             * live).to(torch.bfloat16)
    ws = [(torch.randn(*lead[:-1], E_loc, a, b, generator=g, device="cuda")
           * a ** -0.5).to(torch.bfloat16) for a, b in ((d, f), (d, f),
                                                        (f, d))]
    bwd = k.fused_dispatch_bwd_kernel
    args = (buf, *ws, counts, dfull, group)

    def plain_chunks():
        # the plain version MLA_PLAIN_EXPERTS experts at a time: whole, its
        # f32 transients at these blocks do not fit beside the run's
        out = []
        for e0 in range(0, E_loc, MLA_PLAIN_EXPERTS):
            sl = slice(e0, e0 + MLA_PLAIN_EXPERTS)
            out.append(k.fused_dispatch_bwd_plain(
                buf[..., sl, :, :], *(w[..., sl, :, :] for w in ws),
                counts[..., sl], dfull[..., sl, :, :], group))
        return [torch.cat(parts, dim=-3) for parts in zip(*out)]

    with use_default(dctx):
        got = _counted(bwd, lambda: bwd(*args, plan=plan), "wgmma")
        worst = _bwd_close(torch, got, plain_chunks(),
                           lambda: bwd(*args, plan=plan), 1.6e-2,
                           f"fused_dispatch_bwd at the training plan "
                           f"{tuple(buf.shape)}")
        del got
        torch.cuda.empty_cache()
        transient = bwd.transient_bytes
        fn = lambda: bwd(*args, plan=plan)  # noqa: E731
        ms = cuda_ms(torch, fn, 2)
        dms = device_ms(torch, fn, 2, MOE_BWD_KERNELS)
        plain_ms = cuda_ms(torch, plain_chunks, 1)
    n_live = int(counts.sum())
    nbytes = 2 * (2 * n_live * d + buf.numel()
                  + 2 * sum(w.numel() for w in ws))
    ops = 16 * d * f * n_live
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    row = {"shape": list(buf.shape), "f": f, "live_rows": n_live,
           "overlap": plan.overlap, "max_abs_err": worst, "ms": ms,
           "device_ms": dms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "ops": ops, "library_ms": None,
           "transient_bytes": transient,
           "sets_by_tiles": _tiles_by_set(torch, counts.sum(
               group.rank_dims(dctx.require_mesh())[0]))}
    log(f"fused_dispatch_bwd at the training plan {tuple(buf.shape)}, "
        f"{n_live} live rows (weight sets by packed tiles "
        f"{row['sets_by_tiles']}): {ms:.3f} ms (device {_ms(dms, 3)}), plain "
        f"{plain_ms:.3f} ({MLA_PLAIN_EXPERTS} experts a call), bound "
        f"{b_ms:.3f} ms by {b_by}, rel err {worst:.3g}; scratch and staging "
        f"{transient / 1e9:.3f} GB")
    return row


TRAIN_MOE_F = 1536                 # qwen3-moe's moe_d_ff


def _replayed_routes(torch, choices):
    """``route_topk`` replaying ``choices`` (one ``top_e`` a call, in call
    order): each call's weights are its own probabilities at those experts,
    renormalized as ``route_topk`` renormalizes them."""
    calls = iter(choices)

    def route(toks, router, k):
        top_e = next(calls)
        probs = torch.softmax(torch.matmul(toks.float(), router.float()),
                              dim=-1)
        top_w = torch.gather(probs, -1, top_e)
        return top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9), top_e
    return route


def _route_flips(torch, own, replayed, args):
    """The tokens whose own top-k (its experts in order) differs from the
    replayed one, and the largest, among them, of the token's smallest
    relative gap between neighbouring probabilities of its own top k + 1
    (a choice or its order can only move where two of them nearly tie)."""
    flips, gap = 0, 0.0
    for mine, theirs, (toks, router, k) in zip(own, replayed, args):
        moved = (mine != theirs).any(-1)
        n = int(moved.sum())
        if n:
            with torch.no_grad():
                probs = torch.softmax(torch.matmul(toks.float(),
                                                   router.float()), dim=-1)
                top = torch.topk(probs, k + 1, dim=-1)[0][moved]
                rel = (top[:, :-1] - top[:, 1:]) / top[:, :-1]
            gap = max(gap, float(rel.min(-1)[0].max()))
        flips += n
    return flips, gap


# deepseek-v3 routes after a dense layer and an MLA layer, whose f32 sums in
# another order move its router's probabilities by about 1e-6: over a
# microbatch of 8192 tokens a few sit that close to a tie (4 tokens, the
# widest gap 5.5e-7, on an H100), so its checks allow a token's choices to
# differ where two neighbouring probabilities of its top k + 1 are within
# this relative gap; qwen3-moe's allow none
MOE_CHECK_TIE_GAP = {"deepseek-v3-671b": 1e-4}


def _global_of(t, mesh, spec):
    """``interop.unstack_shards`` on the card: the global tensor a stacked
    one lays out by ``spec`` (replicas read from index 0)."""
    def axes(e):
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)
    used = [a for e in spec for a in axes(e)]
    for a in reversed(mesh.axis_names):
        if a not in used:
            t = t.select(mesh.dim(a), 0)
    kept = [a for a in mesh.axis_names if a in used]
    perm, shape = [], []
    for d, e in enumerate(spec):
        perm += [kept.index(a) for a in axes(e)] + [len(kept) + d]
        shape.append(math.prod(mesh.shape[a] for a in axes(e))
                     * t.shape[len(kept) + d])
    return t.permute(perm).reshape(shape)


def _relayout(t, mesh, src, dst):
    """A stacked tensor laid out by ``src`` moved to ``dst`` on the card
    (the same values: a permutation)."""
    from repro_torch.interop import stack_shards
    return stack_shards(_global_of(t, mesh, src), mesh, dst, device=t.device)


def _moe_train_checks(torch, k, dev, cfg=None, short=False) -> dict:
    """At full width, depth 1 (or ``cfg``'s cut), in f32, on TRAIN_MESH:
    each rank's loss (deepseek-v3's MTP term included),
    gradients and drop counts on the kernels against the same on their
    plain versions, the routing of both asserted identical (every (token,
    choice) of every rank); once under "a2a" (flash and its gradient, the
    expert MLP and its gradient, on the CUDA cores) from one microbatch of
    the phase's traffic (``short``: from one sequence a data rank cut to
    MOE_CHECK_SEQ tokens), and once under "fused" (flash and its gradient,
    the fused dispatch's block-level function and its gradient, joined to
    the scatter and the combine by ``FusedDispatchFn``) from one sequence
    a data rank cut to MOE_CHECK_SEQ tokens.  Under "a2a" a third run,
    "expert2d", holds the kernels under expert2d (the experts over model x
    data, whole at full width, the dispatch over the four ranks: the expert
    leaves of the same weights laid out again on the card) against the
    default layout's plain run on the same tokens; the expert leaves'
    gradients are compared in their global view.  Each kernels' run
    replays the plain run's expert choices (``_replayed_routes``), so all
    compute one function; its own choices must equal them, or, for a
    config in MOE_CHECK_TIE_GAP, differ only at near ties
    (``_route_flips``).  The plain run's gradients wait on the host while
    the kernels' runs: the two runs' f32 gradients
    and activations do not fit the card together; no optimizer state is
    made (the check compares gradients).  Bounds: the loss within 1e-5 and
    each gradient leaf within 5e-3 of its largest per-rank value, the
    recurrent checks' bounds: f32 sums in another order, which the
    embedding table's gradient amplifies (each row sums every position's
    contribution, most of which cancels)."""
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    from repro_torch.kernels.moe_dispatch import fused
    from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import api
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import schema as sch
    from repro_torch.train.step import per_rank_grads

    def blocks_plain(buf, wg, wu, wd, counts, group, plan):
        return fused.fused_dispatch_blocks_plain(buf, wg, wu, wd, counts,
                                                 group)

    def blocks_bwd_plain(buf, wg, wu, wd, counts, dfull, group, *, plan):
        return fused.fused_dispatch_bwd_plain(buf, wg, wu, wd, counts,
                                              dfull, group)

    if cfg is None:
        cfg = _cut(configs.get(MOE_TRAIN_ARCH), 1)
    # flash's forwards and backwards (a forward and a remat forward an
    # attention layer, the MTP layer's included), the expert products'
    attn_layers = cfg.num_layers + int(cfg.mtp)
    moe_layers = cfg.num_layers - cfg.first_k_dense
    launches = [2 * attn_layers, attn_layers, 2 * moe_layers, moe_layers]
    loss_fn = api.loss_fn(cfg)
    mesh = parse_mesh(TRAIN_MESH)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    params = {n: p.float() for n, p in sch.init_params(
        cfg, mesh, torch.Generator(device=dev).manual_seed(1),
        device=dev).items()}
    flash = [(fa_mod, "flash_attention_kernel", k.flash_attention_kernel,
              fa_mod.flash_attention_plain),
             (fa_mod, "flash_attention_bwd_kernel",
              k.flash_attention_bwd_kernel, fa_mod.flash_attention_bwd_plain)]
    impls = {
        "a2a": flash + [
            (mlp_mod, "expert_mlp", k.expert_mlp, mlp_mod.expert_mlp_plain),
            (mlp_mod, "expert_mlp_bwd", k.expert_mlp_bwd,
             mlp_mod.expert_mlp_bwd_plain)],
        # the Fn calls these two by their module names; the counts are
        # kept by the wrappers they stand for
        "fused": flash + [
            (fused, "_dispatch_launch", k.fused_moe_dispatch_kernel,
             blocks_plain),
            (fused, "fused_dispatch_bwd_kernel", k.fused_dispatch_bwd_kernel,
             blocks_bwd_plain)]}
    # the layouts' specs: the expert leaves are the ones that differ
    specs = {e2d: sch.partition_specs(cfg, mesh, rules_for_ctx(
        types.SimpleNamespace(expert2d=e2d))) for e2d in (False, True)}
    moved = sorted(n for n, sp in specs[False].items()
                   if sp != specs[True][n])
    out = {"layers": cfg.num_layers}

    def judge(kp, pp, tag):
        check(kp["launched"] == launches and pp["launched"] == [0] * 4,
              f"{tag}: launches (flash, flash bwd, the expert products, "
              f"their gradient) {kp['launched']} on the kernels, "
              f"{pp['launched']} on the plain versions")
        flips, gap = _route_flips(torch, kp["routes"], pp["routes"],
                                  kp["route_args"])
        loss_err = max_err(torch, kp["loss"], pp["loss"]) / float(
            pp["loss"].abs().max())
        errs = []
        for n, want in pp["grads"].items():
            want, got = want.to(dev), kp["grads"][n]
            if kp["expert2d"] and n in moved:      # the global views
                want = _global_of(want, mesh, specs[False][n])
                got = _global_of(got, mesh, specs[True][n])
            scale = max(float(want.abs().max()), 1e-30)
            errs.append((max_err(torch, got, want) / scale, n))
            del want, got
        errs.sort(reverse=True)
        res = {"tokens": int(kp["tokens"]), "loss_rel": loss_err,
               "grad_rel": errs[0][0], "grad_rel_leaf": errs[0][1],
               "grad_rel_top": errs[:4], "routing_flips": flips,
               "routing_flip_gap": gap,
               "routing_calls": len(kp["routes"]),
               "dropped": float(kp["dropped"].sum()),
               "loss": float(kp["loss"].mean()),
               "peak_memory_gb": kp["peak_memory_gb"]}
        log(f"{tag} at depth {cfg.num_layers} (f32): kernels vs plain "
            + json.dumps(res))
        tie_gap = MOE_CHECK_TIE_GAP.get(cfg.name)
        check(len(kp["routes"]) == len(pp["routes"]) > 0
              and (flips == 0 if tie_gap is None else gap <= tie_gap),
              f"{tag}: {flips} tokens' routing differs between the kernels "
              f"and the plain versions (its widest neighbouring-probability "
              f"gap {gap}, allowed {tie_gap or 'none'})")
        check(torch.equal(kp["dropped"], pp["dropped"]),
              f"{tag}: drops {kp['dropped'].tolist()} on the kernels, "
              f"{pp['dropped'].tolist()} on the plain versions")
        check(loss_err <= 1e-5 and errs[0][0] <= 5e-3,
              f"{tag}: kernels vs plain loss {loss_err}, grads {errs[0]}")
        return res

    for impl, swaps in impls.items():
        wr = [w for _, _, w, _ in swaps]
        runs = {}
        modes = ("plain", "kernels", "expert2d") if impl == "a2a" \
            else ("plain", "kernels")
        with use_default(dctx):
            ctx, _, _, batch = _train_setup(torch, dev, cfg, mesh,
                                            dispatch_impl=impl)
            b0 = batch(0)
            if impl == "a2a" and not short:
                b0 = {n: t.narrow(mesh.ndim, 0, t.shape[mesh.ndim]
                                  // TRAIN_MICRO) for n, t in b0.items()}
            else:           # one sequence a data rank
                b0 = {n: t.narrow(mesh.ndim, 0, 1)
                      .narrow(mesh.ndim + 1, 0, MOE_CHECK_SEQ)
                      for n, t in b0.items()}
            for mode in modes:
                stats = {}
                torch.cuda.reset_peak_memory_stats()

                def framed(p, b, c, x):
                    # the forward's drops (the recompute records nowhere)
                    with dctx.dispatch_stats.collect() as ds:
                        loss = loss_fn(p, b, c, x)
                    stats.update(ds)
                    return loss

                run_ctx = ctx
                if mode == "expert2d":
                    run_ctx = _train_setup(torch, dev, cfg, mesh,
                                           dispatch_impl=impl,
                                           expert2d=True)[0]
                    for n in moved:         # the same weights, laid out again
                        params[n] = _relayout(params[n], mesh,
                                              specs[False][n],
                                              specs[True][n])
                before = [w.launches for w in wr]
                with contextlib.ExitStack() as stack:
                    if mode == "plain":
                        for mod, name, _, plain in swaps:
                            stack.enter_context(_Swap(mod, name, plain))
                    else:
                        stack.enter_context(_Swap(
                            layers_mod, "route_topk", _replayed_routes(
                                torch, runs["plain"]["routes"])))
                    rt = stack.enter_context(_Tap(
                        layers_mod, "route_topk", lambda a, kw: True))
                    loss, grads = per_rank_grads(params, b0, cfg, run_ctx,
                                                 mesh, loss_fn=framed)
                launched = [w.launches - b for w, b in zip(wr, before)]
                if mode == "expert2d":
                    for n in moved:
                        params[n] = _relayout(params[n], mesh,
                                              specs[True][n],
                                              specs[False][n])
                # route_topk returns (top_w, top_e): the tap kept its
                # inputs; each run's own choices are recomputed from them
                # (the same function)
                routes = [layers_mod.route_topk(*a)[1] for a, _ in rt.calls]
                runs[mode] = {"loss": loss, "launched": launched,
                              "routes": routes, "route_args": [
                                  a for a, _ in rt.calls],
                              "dropped": stats["moe_dropped"].clone(),
                              "tokens": b0["tokens"].numel(),
                              "expert2d": mode == "expert2d",
                              "peak_memory_gb":
                                  torch.cuda.max_memory_allocated() / 1e9,
                              "grads": grads if mode != "plain" else
                              {n: t.cpu() for n, t in grads.items()}}
                del grads, rt
                if mode != "plain":
                    tag = f"moe checks {cfg.name} ({impl})" \
                        if mode == "kernels" else \
                        f"moe checks {cfg.name} (expert2d against the " \
                        f"default layout's plain run)"
                    out[impl if mode == "kernels" else mode] = judge(
                        runs.pop(mode), runs["plain"], tag)
                torch.cuda.empty_cache()
        del runs, b0
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def _moe_train_runs(torch, dev, wrappers, cfg, attn_layers, moe_layers,
                    profiled=("a2a", "fused")):
    """``cfg`` trained TRAIN_STEPS steps on TRAIN_MESH under the default
    capacity all-to-all at TRAIN_MICRO, then MOE_FUSED_STEPS steps under the
    dropless fused ring at MOE_FUSED_MICRO, then MOE_FUSED_STEPS steps
    under expert2d at MOE_FUSED_MICRO (the experts over model x data, E / 4
    a rank at full width; ``dispatch_impl="fused"`` asked for, which the
    two-axis EP group turns into the capacity all-to-all over the four
    ranks, as the reference's does) (:func:`_moe_steps`), every
    wrapper's count zeroed just before each run and read just after: each
    of the ``attn_layers`` attention layers a forward and a remat forward
    on flash and a backward on its gradient, each of the ``moe_layers`` MoE
    layers a forward and a remat forward on row 7 and a backward on row 12
    under "a2a" and "expert2d", on rows 8 and 13 under "fused", all on the
    tensor cores, no plain version, no drop under "fused", no launch of
    rows 8 and 13 under "expert2d".  Logs each run's losses, drop
    counts, step times and tokens/s beside the step's bound, its peak
    memory and, for the runs in ``profiled``, one more step
    profiled by kernel group.  Returns the runs
    and, by run, the last step's first backward call of its expert
    rows: row 12's x, dy and counts; row 13's block shape, counts, group
    and plan; and under "a2a_fwd" and "expert2d_fwd" the last step's first
    forward call of row 7 (its blocks, live rows and the weights'
    shapes)."""
    from repro_torch.kernels.moe_dispatch import fused
    from repro_torch.kernels.moe_dispatch import kernel as mlp_mod
    from repro_torch.models import layers as layers_mod

    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, tokens)
    b_ms = flops / PEAK_OPS["bfloat16"] * 1e3
    runs, calls = {}, {}

    def first(key, pick):
        def keep(args, kw):
            if key not in calls:
                calls[key] = pick(args, kw)
            return False
        return keep

    def row12_tap(key):
        return (mlp_mod, "expert_mlp_bwd", first(key, lambda a, kw: (
            a[0].detach().clone(), a[4].detach().clone(), a[5].clone())))

    def row7_tap(key):
        return (layers_mod, "expert_mlp", first(key, lambda a, kw: (
            a[0].detach().clone(), a[4].clone(), tuple(a[1].shape),
            tuple(a[3].shape))))

    for name, impl, steps, micro, knobs in (
            ("a2a", "a2a", TRAIN_STEPS, TRAIN_MICRO, {}),
            ("fused", "fused", MOE_FUSED_STEPS, MOE_FUSED_MICRO, {}),
            ("expert2d", "fused", MOE_FUSED_STEPS, MOE_FUSED_MICRO,
             {"expert2d": True})):
        tag = f"train {cfg.name} ({name})"
        if name == "fused":
            taps = [(fused, "fused_dispatch_bwd_kernel", first(
                name, lambda a, kw: (tuple(a[0].shape), a[4].clone(), a[6],
                                     kw["plan"])))]
        else:
            taps = [row12_tap(name), row7_tap(f"{name}_fwd")]
        run = _moe_steps(torch, dev, wrappers, cfg, steps, taps=taps,
                         profile=name in profiled, dispatch_impl=impl,
                         microbatch=micro, **knobs)
        passes = micro * steps
        launches, routes = run["launches"], run["routes"]
        log(f"{tag}: {cfg.param_count()} parameters, {cfg.num_layers} "
            f"layers, on {TRAIN_MESH}, {steps} steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} tokens (microbatch {micro}) in "
            f"{run['wall_s']:.1f} s; losses {run['losses']}, grad norms "
            f"{run['grad_norms']}, drops {run['moe_dropped']} (rates "
            f"{run['moe_drop_rate']}); launches {launches}, routes {routes}; "
            f"plain calls {run['plain_calls']}; peak "
            f"{run['peak_memory_gb']:.2f} GB")
        check(all(math.isfinite(x) for x in run["losses"] + run["grad_norms"])
              and len(run["losses"]) == steps, f"{tag}: a non-finite step")
        moe = ({"fused_moe_dispatch": 2 * moe_layers * passes,
                "fused_moe_dispatch_bwd": moe_layers * passes}
               if name == "fused" else
               {"expert_mlp": 2 * moe_layers * passes,
                "expert_mlp_bwd": moe_layers * passes})
        want = {"flash_attention": 2 * attn_layers * passes,
                "flash_attention_bwd": attn_layers * passes, **moe}
        check(all(launches[n] == c for n, c in want.items())
              and all(c == 0 for n, c in launches.items() if n not in want),
              f"{tag}: launches {launches}, not {want}")
        check(all(routes[n] == {"simt": 0, "wgmma": c}
                  for n, c in want.items()), f"{tag}: routes {routes}")
        check(not any(run["plain_calls"].values()),
              f"{tag}: a plain version ran: {run['plain_calls']}")
        if name == "fused":
            check(not any(run["moe_dropped"]),
                  f"{tag}: the dropless ring dropped {run['moe_dropped']}")
        steps_ms = [{"ms": s * 1e3, "tokens_per_s": tokens / s}
                    for s in run["step_s"]]
        log(f"{tag}: step times (ms, the first with its warm-up) "
            f"{[round(s['ms'], 2) for s in steps_ms]}, tokens/s "
            f"{[round(s['tokens_per_s'], 1) for s in steps_ms]}; bound "
            f"{b_ms:.2f} ms a step ({flops:.4g} operations at the bf16 "
            f"tensor-core rate); one step profiled: "
            f"{run['breakdown'] or 'not profiled'}")
        runs[name] = {"layers": cfg.num_layers,
                      "parameters": cfg.param_count(), "microbatch": micro,
                      "step_ms": steps_ms, "bound_ms": b_ms,
                      "peak_memory_gb": run["peak_memory_gb"],
                      "losses": run["losses"],
                      "grad_norms": run["grad_norms"],
                      "moe_dropped": run["moe_dropped"],
                      "moe_drop_rate": run["moe_drop_rate"],
                      "launches": {n: launches[n] for n in want},
                      "routes": {n: routes[n] for n in want},
                      "breakdown": run["breakdown"]}
        if knobs:
            runs[name]["knobs"] = {**knobs, "dispatch_impl": impl}
        del run
        torch.cuda.empty_cache()
    return runs, calls


def moe_train_phase(torch, k, dev, wrappers) -> dict:
    """qwen3-moe-235b-a22b at full width, depth cut to MOE_TRAIN_LAYERS,
    trained TRAIN_STEPS steps on TRAIN_MESH under the default capacity
    all-to-all, then MOE_FUSED_STEPS steps under the dropless fused ring
    in microbatches of MOE_FUSED_MICRO;
    every wrapper's count zeroed just before each run and read just after:
    under "a2a" every attention's forward and remat forward on flash (G =
    16, D = 128) and every backward on its gradient, every expert MLP's
    forward and remat forward on row 7 and every backward on row 12, all
    on the tensor cores; under "fused" the same attention and every MoE
    layer's forward and remat forward on row 8 and backward on row 13; no
    plain version on either path; then MOE_FUSED_STEPS steps under
    expert2d (E / 4 = 32 experts a rank from 4 sources at full width),
    every expert MLP on rows 7 and 12 and none on rows 8 and 13.  Each
    run's losses, drop counts, step times and tokens/s beside the step's
    bound, its peak memory and, for the first two, one more step profiled
    by kernel group; rows 12 and 13 at the runs' own shapes against their
    plain versions, and rows 12 and 7 at the expert2d run's own calls; then
    the f32 depth-1 checks under both dispatches and expert2d against the
    default layout.  Returns the rows-12 and -13 lines of the ``kernels``
    JSON and row 7's expert2d instance."""
    from repro_torch import configs
    from repro_torch.core.context import DiompContext
    from repro_torch.launch.train import parse_mesh

    cfg = _cut(configs.get(MOE_TRAIN_ARCH), MOE_TRAIN_LAYERS)
    g = torch.Generator(device=dev).manual_seed(9)
    runs, calls = _moe_train_runs(torch, dev, wrappers, cfg, cfg.num_layers,
                                  cfg.num_layers)
    # rows 12 and 13 at the runs' own calls
    row12 = _expert_bwd_at(torch, k, g, *calls.pop("a2a"))
    shape, counts, group, plan = calls.pop("fused")
    dctx = DiompContext(mesh=parse_mesh(TRAIN_MESH), device=dev)
    row13 = _dispatch_bwd_at(torch, k, g, dctx, counts, plan, group, shape)
    del counts
    torch.cuda.empty_cache()
    # rows 12 and 7 at the expert2d run's own calls, row 7 also at the
    # default layout's (random weights at their shapes: a rank's 32 whole
    # experts, or its 64 gathered ones)
    row12_e2d = _expert_bwd_at(torch, k, g, *calls.pop("expert2d"))
    row7 = {}
    for name in ("expert2d", "a2a"):
        x, live, gshape, dshape = calls.pop(f"{name}_fwd")
        ws = [(torch.randn(*shp, generator=g, device=dev) * shp[-2] ** -0.5)
              .to(x.dtype) for shp in (gshape, gshape, dshape)]
        row7[name] = _expert_mlp_at(torch, k, f"{name} training call", x,
                                    *ws, live)
        del x, live, ws
        torch.cuda.empty_cache()
    row7_e2d = row7["expert2d"]
    row7_e2d["launches"] = runs["expert2d"]["launches"]["expert_mlp"]
    row7_e2d["default_layout_call"] = row7["a2a"]
    checks = _moe_train_checks(torch, k, dev)
    lines = []
    for name, source, replaces, run, row in (
            ("expert_mlp_bwd", "src/repro_torch/csrc/expert_mlp_bwd.cu",
             "src/repro/kernels/moe_dispatch/kernel.py:44 (the gradient of "
             "its forward; the reference differentiates jnp.einsum, "
             "src/repro/models/layers.py:831-881)", "a2a", row12),
            ("fused_moe_dispatch_bwd",
             "src/repro_torch/csrc/moe_dispatch_bwd.cu",
             "src/repro/kernels/moe_dispatch/fused.py:284 (the gradient of "
             "its forward; the reference differentiates its emulation)",
             "fused", row13)):
        wrapper = name if name == "expert_mlp_bwd" \
            else "fused_moe_dispatch_bwd"
        line = {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": runs[run]["launches"][wrapper],
                "route_launches": runs[run]["routes"][wrapper]}
        line.update(row)
        line["train"] = runs[run]
        lines.append(line)
    for line, impl in zip(lines, ("a2a", "fused")):
        line["checks"] = {"layers": checks["layers"], **checks[impl]}
    lines[0]["expert2d"] = {
        **row12_e2d,
        "launches": runs["expert2d"]["launches"]["expert_mlp_bwd"],
        "train": runs["expert2d"],
        "checks": {"layers": checks["layers"], **checks["expert2d"]}}
    return lines + [row7_e2d]


# -- training deepseek-v3: MLA, its MTP term, row 10 at D = 192 --------------

# deepseek-v3-671b at full width (d_model 7168, 128 heads of MLA: q / kv
# lora 1536 / 512, nope / rope 128 / 64, v 128; d_ff 18432, moe_d_ff 2048,
# top-8 with 1 shared expert, vocab 129,280) with its MTP module whole and
# its depth and experts cut to fit one card: 1 of its 3 leading dense
# layers, 1 of its 58 MoE layers, 16 of its 256 routed experts (8 a rank at
# EP = 2).  That is 3.707e9 parameters; the 3 dense + 1 MoE layers at 256
# experts hold 1.54e10, past what one card trains.  The traffic is
# qwen3-moe's (moe_train_phase): Adafactor on TRAIN_MESH, TRAIN_STEPS steps
# under the capacity all-to-all at TRAIN_MICRO, then MOE_FUSED_STEPS under
# the fused ring at MOE_FUSED_MICRO.
DS_TRAIN_ARCH = "deepseek-v3-671b"
DS_TRAIN_CUT = {"num_layers": 2, "first_k_dense": 1, "num_experts": 16}


def deepseek_train_phase(torch, k, dev, wrappers) -> dict:
    """deepseek-v3 at the DS_TRAIN_CUT cut, trained as qwen3-moe is
    (:func:`moe_train_phase`), every wrapper's count zeroed just before each
    run and read just after: every attention (the dense, MoE and MTP
    layers: MLA at D = 192, Dv = 128) a forward and a remat forward on row
    5 and a backward on row 10, all on the tensor cores; under "a2a" the
    MoE layer's expert MLP forward and remat forward on row 7 and its
    backward on row 12, under "fused" on rows 8 and 13; no plain version.
    Each run's losses, grad norms, drops, step times and tokens/s beside
    the step's bound, its peak memory and one more step profiled by kernel
    group; row 10 at the step's own shape (:func:`_bwd_at`: against its
    plain version, twice for equal bits, timed beside SDPA's backward and
    its bound; the forward with the lse there too); rows 12 and 13 at the
    runs' own calls (d 7168, f 2048); then the f32 checks of
    :func:`_moe_train_checks` at the same cut under both dispatches and
    under expert2d (16 experts, 4 a rank at EP = 4) against the default
    layout."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.context import DiompContext
    from repro_torch.launch.train import parse_mesh

    t_phase = time.perf_counter()
    full = configs.get(DS_TRAIN_ARCH)
    cfg = dataclasses.replace(full, **DS_TRAIN_CUT)
    moe_layers = cfg.num_layers - cfg.first_k_dense
    log(f"train {DS_TRAIN_ARCH}: cut to {cfg.first_k_dense} of "
        f"{full.first_k_dense} dense layers, {moe_layers} of "
        f"{full.num_layers - full.first_k_dense} MoE layers, "
        f"{cfg.num_experts} of {full.num_experts} routed experts, the MTP "
        f"module whole: {cfg.param_count()} parameters (the whole model "
        f"{full.param_count()}); full width")
    g = torch.Generator(device=dev).manual_seed(11)
    # the attention layers: the dense, the MoE and the MTP layer; one
    # profiled step, the capacity all-to-all's
    runs, calls = _moe_train_runs(torch, dev, wrappers, cfg,
                                  cfg.num_layers + 1, moe_layers,
                                  profiled=("a2a",))
    # row 10 at one attention layer's call of the step: ranks 2 x 2, a
    # microbatch of 2 sequences of TRAIN_SEQ, 64 heads a rank (KH = H: MLA
    # expands its shared rope key), D 192, Dv 128, bf16
    D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    lead = (2, 2, TRAIN_BATCH // 2 // TRAIN_MICRO, TRAIN_SEQ,
            cfg.num_heads // 2)
    Dv = cfg.v_head_dim
    q, kk, v, do = (torch.randn(*lead, w, generator=g, device=dev)
                    .to(torch.bfloat16) for w in (D, D, Dv, Dv))
    row10 = _bwd_at(torch, k, q, kk, v, do)
    del q, kk, v, do
    torch.cuda.empty_cache()
    # rows 12 and 13 at the runs' own calls
    row12 = _expert_bwd_at(torch, k, g, *calls.pop("a2a"), f=cfg.moe_d_ff)
    shape, counts, group, plan = calls.pop("fused")
    dctx = DiompContext(mesh=parse_mesh(TRAIN_MESH), device=dev)
    row13 = _dispatch_bwd_at(torch, k, g, dctx, counts, plan, group, shape,
                             f=cfg.moe_d_ff)
    del counts
    calls.clear()                   # the expert2d run's calls: not timed
    torch.cuda.empty_cache()
    checks = _moe_train_checks(torch, k, dev, cfg, short=True)
    seconds = time.perf_counter() - t_phase
    log(f"train {cfg.name}: the phase took {seconds:.1f} s")
    return {"runs": runs, "row10": row10, "row12": row12, "row13": row13,
            "checks": checks, "seconds": seconds}


# -- the weight ring of the ZeRO-3 gather (use_ring_matmul) -----------------

RING_TRAIN_STEPS = 2


def ring_train_phase(torch, k, dev) -> dict:
    """stablelm-3b with ``use_ring_matmul=True`` (W's ZeRO-3 shards
    circulate round the data ring by one-sided puts instead of being
    gathered): at depth TRAIN_CUT_LAYERS on TRAIN_MESH, with f32 weights,
    each rank's loss and gradients under ``ring_impl`` "fused" and "host"
    against the all-gather path's (the loss within 1e-5, each leaf within
    1e-4 of its largest per-rank value: in f32 the two paths differ only in
    the order of the GEMMs' sums), the forward's puts logged; then
    RING_TRAIN_STEPS steps at full width and depth in bf16 under "fused",
    each in turn with an all-gather step on the same traffic, their times
    side by side."""
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import schema as sch
    from repro_torch.train.step import per_rank_grads

    mesh = parse_mesh(TRAIN_MESH)
    out = {}
    cfg = _cut(configs.get(TRAIN_ARCH), TRAIN_CUT_LAYERS)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    params = {n: p.float() for n, p in sch.init_params(
        cfg, mesh, torch.Generator(device=dev).manual_seed(1),
        device=dev).items()}
    with use_default(dctx):
        ctx, _, _, batch = _train_setup(torch, dev, cfg, mesh)
        b0 = batch(0)
        l_g, g_g = per_rank_grads(params, b0, cfg, ctx, mesh)
        for impl in ("fused", "host"):
            rctx, _, _, _ = _train_setup(torch, dev, cfg, mesh,
                                         use_ring_matmul=True, ring_impl=impl)
            before = dctx.byte_stats()
            l_r, g_r = per_rank_grads(params, b0, cfg, rctx, mesh)
            puts = {grp: v.get("put", 0) - before.get(grp, {}).get("put", 0)
                    for grp, v in dctx.byte_stats().items()}
            loss_err = max_err(torch, l_r, l_g) / float(l_g.abs().max())
            worst = max((max_err(torch, g_r[n], g_g[n]) / max(
                float(g_g[n].float().abs().max()), 1e-30), n) for n in g_g)
            out[f"depth{TRAIN_CUT_LAYERS}_{impl}"] = {
                "loss_rel": loss_err, "grad_rel": worst[0],
                "grad_rel_leaf": worst[1],
                "put_bytes": {g_: b for g_, b in puts.items() if b}}
            check(loss_err <= 1e-5 and worst[0] <= 1e-4,
                  f"ring {impl} vs all-gather at depth {TRAIN_CUT_LAYERS}: "
                  f"loss {loss_err}, grads {worst}")
            check(any(puts.values()), f"ring {impl}: no put was logged")
            del g_r
    del params, g_g
    torch.cuda.empty_cache()
    log("ring: " + json.dumps(out))

    # full width and depth: ring and all-gather steps in turns
    cfg = configs.get(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    with use_default(dctx):
        _, opt, gather_step, batch = _train_setup(torch, dev, cfg, mesh,
                                                  donate=True)
        _, _, ring_step, _ = _train_setup(torch, dev, cfg, mesh, donate=True,
                                          use_ring_matmul=True,
                                          ring_impl="fused")
        state = [sch.init_params(cfg, mesh, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)]
        state.append(opt.init(state[0]))
        times = {"ring": [], "allgather": []}
        losses = {"ring": [], "allgather": []}
        for i in range(RING_TRAIN_STEPS):
            b = batch(i)
            for name, step in (("ring", ring_step),
                               ("allgather", gather_step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state[0], state[1], met = step(state[0], state[1], b, i)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                losses[name].append(float(met["loss"].reshape(-1)[0]))
    del state
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          "ring: a non-finite full-width step")
    out["full"] = {"step_ms": times, "losses": losses,
                   "tokens_per_s": {n: [tokens / t * 1e3 for t in v]
                                    for n, v in times.items()},
                   "peak_memory_gb": peak}
    log(f"ring: {cfg.name} at full width and depth on {TRAIN_MESH}, "
        f"{RING_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"turns (the first of each with its warm-up): ring (fused) "
        f"{[round(t, 2) for t in times['ring']]} ms, all-gather "
        f"{[round(t, 2) for t in times['allgather']]} ms; losses {losses}; "
        f"peak {peak:.2f} GB")
    return out


# -- the long-context decode: zamba2-1.2b at 524,288 tokens -----------------


RING_TRAIN_CUT = 1024     # tokens a rank of the f32 cut of the ring phase
RING_BWD_KERNELS = ("ring_bwd_kernel", "ring_bwd_tc_kernel")


def _block_grads(torch, dev, cfg, mesh, lp, x, ct, sp):
    """paligemma-3b's attention block (``models/layers.py`` attention_block,
    token-parallel) under ``seq_parallel=sp``: its output on rank 0's
    replica, and the gradients of the scalar loss <that output, ct> with
    respect to x and to each weight, each summed over the ranks (the
    replicas' shares)."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.models import layers
    from repro_torch.models.config import ParallelCtx
    pctx = ParallelCtx.from_mesh(mesh, seq_parallel=sp)
    nd = mesh.ndim
    xs = x.expand(*mesh.sizes, *x.shape).clone().requires_grad_()
    w = {n: t.detach().clone().requires_grad_() for n, t in lp.items()}
    with use_default(DiompContext(mesh=mesh, device=dev)):
        out, _ = layers.attention_block(xs, w, cfg, pctx)
        first = out[(0,) * nd]
        loss = (first.float() * ct).sum()
        grads = torch.autograd.grad(loss, [xs, *w.values()])
    ranks = tuple(range(nd))
    return first.detach(), {n: g.sum(dim=ranks) for n, g in
                            zip(("x", *w), grads)}


def _ring_bwd_at(torch, k, g, n, t_loc, H, KH, hd):
    """Row 14 at the sequence-parallel training shape (``n`` ranks of
    ``t_loc`` tokens, queries sharded, causal, bf16): against its plain
    version (the chain form) and a second launch, timed by CUDA events and
    device time beside its bound, the plain version, row 9's forward with
    and without the lse, row 10 and SDPA's backward on the same global
    causal problem (SDPA's K and V heads repeated to the query heads)."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.plan import OverlapPlanner
    from repro_torch.launch.mesh import RankMesh
    group = DiompGroup(("x",), name="x")
    dev, dt = g.device, torch.bfloat16
    q = torch.randn(n, 1, t_loc, H, hd, generator=g, device=dev).to(dt)
    kk, v = (torch.randn(n, 1, t_loc, KH, hd, generator=g, device=dev).to(dt)
             for _ in range(2))
    do = torch.randn(n, 1, t_loc, H, hd, generator=g, device=dev).to(dt)
    plan = OverlapPlanner().plan_ring_attention(1, t_loc, t_loc, H, KH, hd,
                                                hd, dt, n)
    fwd, bwd = k.fused_ring_attention_kernel, k.fused_ring_attention_bwd_kernel
    with use_default(DiompContext(mesh=RankMesh(("x",), (n,)), device=dev)):
        o, lse = fwd(q, kk, v, group, plan=plan, return_lse=True)

        def call():
            return bwd(q, kk, v, o, do, lse, group, plan=plan)

        route = _ring_bwd_route(torch, dt, hd, hd, H // KH)
        got = _counted(bwd, call, route)
        check(all(torch.equal(a, b) for a, b in zip(got, call())),
              "ring bwd at the training shape: two launches differ")
        t0 = time.perf_counter()
        want = k.fused_ring_attention_bwd_plain(q, kk, v, do, group,
                                                plan=plan)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        errs = {name: max_err(torch, a, b) for name, a, b in
                zip(("dq", "dk", "dv"), got, want)}
        scales = {name: float(b.float().abs().max()) for name, b in
                  zip(("dq", "dk", "dv"), want)}
        del want
        for name, err in errs.items():
            check(err <= 1.6e-2 * scales[name],
                  f"ring bwd at the training shape: {name} err {err} (scale "
                  f"{scales[name]})")
        ms = cuda_ms(torch, call, 3)
        dev_ms = device_ms(torch, call, 3, RING_BWD_KERNELS)
        fwd_ms = cuda_ms(torch, lambda: fwd(q, kk, v, group, plan=plan), 3)
        fwd_lse_ms = cuda_ms(torch, lambda: fwd(q, kk, v, group, plan=plan,
                                                return_lse=True), 3)
        fwd_dev = device_ms(torch, lambda: fwd(q, kk, v, group, plan=plan),
                            3, ("ring_attention",))
        fwd_lse_dev = device_ms(torch, lambda: fwd(
            q, kk, v, group, plan=plan, return_lse=True), 3,
            ("ring_attention",))
    del got, o, lse
    # row 10 on the same global problem (flash's forward for o and the lse;
    # its rule gives the same route as row 14's here)
    whole = [t.movedim(0, 1).flatten(1, 2) for t in (q, kk, v, do)]
    o, lse = k.flash_attention_kernel(*whole[:3], return_lse=True)

    def row10_call():
        return k.flash_attention_bwd_kernel(*whole[:3], o, whole[3], lse)

    row10 = cuda_ms(torch, row10_call, 2)
    row10_dev = device_ms(torch, row10_call, 2,
                          ("bwd_rows_kernel", "dkdv_", "dq_"))
    row10_route = k.flash_attention_bwd_kernel.last_grid["route"]
    check(row10_route == route, f"row 10 at head_dim {hd} on {row10_route}, "
          f"row 14 on {route}")
    del o, lse
    # SDPA's backward over the whole sequence (the ranks' rows in order)
    whole[1], whole[2] = (t.repeat_interleave(H // KH, dim=-2)
                          for t in whole[1:3])
    sdpa = _sdpa_grad(torch, whole[0], whole[1], whole[2], whole[3],
                      pin=True)
    library = cuda_ms(torch, sdpa, 3)
    library_dev = device_ms(torch, sdpa, 3, ("",))
    T = n * t_loc
    pairs = T * (T + 1) // 2 * H
    nbytes = 2 * (3 * q.numel() + 4 * kk.numel()) + 4 * q.numel() // hd
    b_ms, b_by = bound(nbytes, 2 * (3 * hd + 2 * hd) * pairs, "bfloat16")
    # the registers and spills of the bf16 instances these launches ran
    # (their mangled names: the tensor-core instances by width)
    wide = hd == 256 and route == "wgmma"
    ptxas = {"row14": _ptxas_of("ring_attention_bwd",
                                f"ring_bwd_tc_kernelI13__nv_bfloat16Li"
                                f"{256 if wide else 128}E"),
             "row10": _ptxas_of("flash_attention_bwd",
                                "_w_kernelI13__nv_bfloat16E" if wide else
                                "kernelI13__nv_bfloat16Li128E")}
    log(f"ring bwd at head_dim {hd}: ptxas {ptxas}")
    log(f"ring bwd (row 14, {route}) at {n} x {t_loc} tokens, {H} heads on "
        f"{KH}, head_dim {hd}, causal, bf16 ({pairs // H} visible pairs a "
        f"head): "
        f"{ms:.3f} ms (device {_ms(dev_ms, 3)}), plain {plain:.1f}, bound "
        f"{b_ms:.4f} ms by {b_by}, sdpa backward {library:.3f} (device "
        f"{_ms(library_dev, 3)}; backend {sdpa.backend}, "
        f"K/V heads repeated); err {errs} of {scales}; row 9 forward "
        f"{fwd_ms:.3f} ms (device {_ms(fwd_dev, 3)}), with the lse "
        f"{fwd_lse_ms:.3f} (device {_ms(fwd_lse_dev, 3)}); row 10 on the "
        f"same global problem {row10:.3f} ms (device {_ms(row10_dev, 3)}; "
        f"{row10_route})")
    return {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "device_ms": dev_ms, "library_device_ms": library_dev,
            "library_backend": sdpa.backend,
            "errs": errs, "scales": scales,
            "shape": f"{n} x {t_loc} tokens, {H} heads on {KH}, D {hd}",
            "kernel_route": route,
            "row10_same_problem": {"ms": row10, "device_ms": row10_dev,
                                   "route": row10_route},
            "ptxas": ptxas,
            "row9_forward": {"ms": fwd_ms, "device_ms": fwd_dev,
                             "with_lse_ms": fwd_lse_ms,
                             "with_lse_device_ms": fwd_lse_dev}}


def ring_attention_train_phase(torch, k, dev, wrappers) -> dict:
    """Train paligemma-3b's attention block under ``seq_parallel="ring"``
    at full width (d 2048, 8 heads on 1 kv head, head_dim 256; random bf16
    weights) on data 1 x model 4, B = 1, 4 x 4096 tokens, against the same
    block under ``"allgather"`` (row 5 and row 10): the forward and the
    backward of a scalar loss, the output and the gradients of x and of
    the block's weights within 3e-2 of each tensor's largest magnitude in
    bf16 (row 14 and row 10 both round to bf16, in other orders, and the
    differences pass through the block's products); rows 9 and 14 launched
    once each a ring run, never flash or its gradient, and the plain
    versions never called; in bf16 rows 14 and 10 on the tensor cores (the
    256-wide instances), in f32 on the CUDA cores.  Then an f32 cut (4 x 1024 tokens): the ring's
    gradients against the plain emulation's (its chain-form VJP, swapped
    in for the kernel) within 1e-4 of each magnitude.  Then row 14 alone
    at the bf16 shape (``_ring_bwd_at``), and at head_dim 128 on the
    tensor cores.  Returns row 14's line of the
    ``kernels`` JSON, with row 9's launches under ``"row9"``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ring_attention import fused as ra_fused
    from repro_torch.kernels.ring_attention import ops as ra_ops
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import schema as sch

    t_start = time.perf_counter()
    cfg = dataclasses.replace(configs.get(RING_ARCH), num_layers=1)
    check(not sch.head_parallel(cfg), "paligemma's attention is not "
          "token-parallel")
    mesh = RankMesh(("data", "model"), (1, SEQ_RANKS))
    g = torch.Generator(device=dev).manual_seed(11)
    params = sch.init_params(cfg, mesh, g, device=dev)
    lp = {n.split("/")[1]: p.select(mesh.ndim, 0) for n, p in params.items()
          if n.startswith("layers/") and n.split("/")[1] in
          ("wq", "wk", "wv", "wo")}
    del params
    T = SEQ_RANKS * SEQ_T_LOC
    names = ("fused_ring_attention", "fused_ring_attention_bwd",
             "flash_attention", "flash_attention_bwd")
    out = {}
    for dt, t, tol in ((torch.bfloat16, T, 3e-2),
                       (torch.float32, SEQ_RANKS * RING_TRAIN_CUT, 1e-4)):
        x = torch.randn(1, t, cfg.d_model, generator=g, device=dev).to(dt)
        ct = torch.randn(1, t, cfg.d_model, generator=g, device=dev)
        w = {n: p.to(dt) for n, p in lp.items()}
        runs = {}
        for sp in ("ring", "allgather"):
            _zero_counts(wrappers)
            # the plain versions are taps that must record no call
            with _Tap(ra_fused, "fused_ring_attention_interpret",
                      lambda a, kw: True) as fplain, \
                    _Tap(ra_fused, "_ring_grads",
                         lambda a, kw: True) as bplain:
                t0 = time.perf_counter()
                runs[sp] = _block_grads(torch, dev, cfg, mesh, w, x, ct, sp)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            counts = {n: wrappers[n].launches for n in names}
            want = ({"fused_ring_attention": 1, "fused_ring_attention_bwd": 1,
                     "flash_attention": 0, "flash_attention_bwd": 0}
                    if sp == "ring" else
                    {"fused_ring_attention": 0, "fused_ring_attention_bwd": 0,
                     "flash_attention": 1, "flash_attention_bwd": 1})
            check(counts == want and not fplain.calls and not bplain.calls,
                  f"ring train {dt} {sp}: launches {counts}, plain calls "
                  f"{len(fplain.calls)} + {len(bplain.calls)}")
            out.setdefault(str(dt), {})[sp] = {
                "launches": counts, "seconds": secs,
                "routes": {n: dict(wrappers[n].route_launches)
                           for n in names}}
            log(f"ring train {dt}: {sp} block forward + backward at "
                f"{SEQ_RANKS} x {t // SEQ_RANKS} tokens in {secs:.2f} s, "
                f"launches {counts}")
        if dt == torch.float32:
            # the plain emulation's gradient (the chain form) on the card's
            # tensors: the kernel wrapper swapped for the emulation
            with _Swap(ra_ops, "fused_ring_attention_kernel",
                       ra_fused.fused_ring_attention_interpret):
                runs["plain"] = _block_grads(torch, dev, cfg, mesh, w, x, ct,
                                             "ring")
        errs = {}
        for other in [r for r in runs if r != "ring"]:
            (o_r, g_r), (o_o, g_o) = runs["ring"], runs[other]
            for name, a, b in [("out", o_r, o_o)] + [
                    (n, g_r[n], g_o[n]) for n in g_r]:
                err = max_err(torch, a, b)
                scale = max(float(b.float().abs().max()), 1e-30)
                errs[f"{other} {name}"] = err / scale
                check(bool(torch.isfinite(a).all()) and err <= tol * scale,
                      f"ring train {dt}: {name} under 'ring' differs from "
                      f"{other} by {err} (scale {scale})")
        out[str(dt)]["rel_errs"] = errs
        log(f"ring train {dt}: 'ring' against "
            f"{[r for r in runs if r != 'ring']}, errors relative to each "
            f"tensor's largest magnitude (limit {tol}): "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
        del runs, x, ct, w
        torch.cuda.empty_cache()
    def routes(name):
        return {r: sum(out[d]["ring"]["routes"][name][r] for d in out)
                for r in ("simt", "wgmma")}

    # every launch on its rule's route: in bf16 rows 9 and 14 under "ring"
    # and rows 5 and 10 under "allgather" on the tensor cores (D = Dv =
    # 256: the gradients' 256-wide instances), in f32 both gradients on
    # the CUDA cores
    bf, f32 = out[str(torch.bfloat16)], out[str(torch.float32)]
    check(bf["ring"]["routes"]["fused_ring_attention"]["wgmma"] == 1
          and bf["ring"]["routes"]["fused_ring_attention_bwd"]["wgmma"] == 1
          and bf["allgather"]["routes"]["flash_attention"]["wgmma"] == 1
          and bf["allgather"]["routes"]["flash_attention_bwd"]["wgmma"] == 1
          and f32["ring"]["routes"]["fused_ring_attention_bwd"]["simt"] == 1
          and f32["allgather"]["routes"]["flash_attention_bwd"]["simt"] == 1,
          "ring train: routes " + str({(d, sp): out[d][sp]["routes"]
                                       for d in out
                                       for sp in ("ring", "allgather")}))
    launches = sum(out[d]["ring"]["launches"]["fused_ring_attention_bwd"]
                   for d in out)
    row9 = sum(out[d]["ring"]["launches"]["fused_ring_attention"] for d in out)
    line = {"name": "fused_ring_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ring_attention_bwd.cu",
            "replaces": "src/repro/kernels/ring_attention/fused.py:362 (the "
                        "gradient of its forward; the reference "
                        "differentiates its emulation's custom VJP, "
                        "fused.py:169-219)",
            "launches": launches,
            "route_launches": routes("fused_ring_attention_bwd"),
            "shape": f"train: {SEQ_RANKS} x {SEQ_T_LOC}"}
    line.update(_ring_bwd_at(torch, k, torch.Generator(device=dev)
                             .manual_seed(12), SEQ_RANKS, SEQ_T_LOC,
                             cfg.num_heads, cfg.kv_heads, cfg.head_dim))
    # the narrow tensor-core instance at the same layout with head_dim 128:
    # no config trains through the ring there
    line["tensor_cores_d128"] = _ring_bwd_at(
        torch, k, torch.Generator(device=dev).manual_seed(13), SEQ_RANKS,
        SEQ_T_LOC, cfg.num_heads, cfg.kv_heads, 128)
    line["train"] = out
    line["row9"] = {"launches": row9}
    line["phase_s"] = time.perf_counter() - t_start
    log(f"ring train: phase in {line['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return line


def _fill_rows(torch, cache, sharded, lo, hi, g, src=None):
    """Rows ``[lo, hi)`` of the global sequence in a stacked K/V cache
    ``(data, model, n_app, B, rows, KH, D)``, context-sharded over "data"
    or replicated: from ``src`` (those global rows, ``(model, n_app, B,
    hi - lo, KH, D)``) or drawn from ``g``."""
    s_loc = cache.shape[-3]
    for r in range(cache.shape[0]):
        start = r * s_loc if sharded else 0
        a, b = max(lo, start), min(hi, start + s_loc)
        if a >= b:
            continue
        rows = cache[r, :, :, :, a - start:b - start]
        if src is None:
            rows.normal_(0.0, 1.0, generator=g)
        else:
            rows.copy_(src[:, :, :, a - lo:b - lo])


def _cp_partial_at(torch, k, args, kw):
    """Row 5's kernel at the cp partial of the long decode (the arguments a
    shared-block application gave it): against its plain version (output
    and lse), timed (events and device time), its bound (the valid K/V rows
    read once; two products over the visible pairs) and SDPA over the same
    visible keys (a boolean mask)."""
    q, kk, v = args
    Tq, H, D = q.shape[-3:]
    Tk, KH, Dv = kk.shape[-3], kk.shape[-2], v.shape[-1]
    vl = torch.as_tensor(kw["valid_len"]).expand(q.shape[:-3]).contiguous()

    def call():
        return k.flash_attention_kernel(q, kk, v, causal=False, valid_len=vl,
                                        return_lse=True)

    got, lse = _counted(k.flash_attention_kernel, call, "wgmma")
    grid = dict(k.flash_attention_kernel.last_grid)
    want, wlse = k.flash_attention_plain(q, kk, v, causal=False, valid_len=vl,
                                         return_lse=True)
    err = max_err(torch, got, want)
    l_err = max_err(torch, lse, wlse)
    check(bool(torch.isfinite(got).all()) and l_err <= 1e-3
          and err <= 1.6e-2 * float(want.float().abs().max()),
          f"cp partial: err {err}, lse err {l_err}")
    del got, want, lse, wlse
    keys = int(vl.sum())
    nbytes = 2 * (q.numel() + keys * KH * (D + Dv) + q.numel() // D * Dv) \
        + 4 * q.numel() // D
    b_ms, b_by = bound(nbytes, 2 * keys * H * Tq * (D + Dv), "bfloat16")
    ms = cuda_ms(torch, call, 10)
    dev = device_ms(torch, call, 10, FLASH_KERNELS)
    plain = cuda_ms(torch, lambda: k.flash_attention_plain(
        q, kk, v, causal=False, valid_len=vl, return_lse=True), 1)
    visible = (torch.arange(Tk, device=q.device)
               < vl.reshape(-1, 1, 1)).expand(-1, Tq, Tk)
    sdpa = _sdpa(torch, q, kk, v, visible)
    library = cuda_ms(torch, sdpa, 10)
    library_dev = device_ms(torch, sdpa, 10, ("",))
    del visible, sdpa
    log(f"cp partial: q {tuple(q.shape)} k {tuple(kk.shape)} ({keys} valid "
        f"keys over {vl.numel()} (rank, row) pairs; {grid}): {ms:.4f} ms "
        f"(device {_ms(dev, 4)}), plain {plain:.2f}, sdpa over the same "
        f"keys {library:.4f} (device {_ms(library_dev, 4)}), bound "
        f"{b_ms:.4f} ms by {b_by}, err {err:.4g}, lse err {l_err:.3g}")
    return {"max_abs_err": err, "lse_abs_err": l_err, "ms": ms,
            "device_ms": dev, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "library_device_ms": library_dev, "blocks": grid["blocks"],
            "splits": grid["splits"], "shape": list(q.shape),
            "keys": list(kk.shape)}


def long_decode_phase(torch, k, dev, wrappers) -> dict:
    """zamba2-1.2b at full width and depth at the reference's long_500k cell
    (B = 1, S = 524,288) on data 4 x model 2: the shared block's K/V caches
    context-sharded over "data" through the port's prefill and decode
    steps (``seq_sharded=True``), every decode step's attention
    ``cp_decode_attention`` (row 5's kernel a rank with the lse, three
    OMPCCL all-reduces).  A REC_PROMPT-token prompt is prefilled, the
    later rows filled from a seed, and LONG_NEW greedy steps run from pos
    = S - LONG_TAIL with every wrapper's count zeroed just before and read
    just after; then the cp partial alone at its 131,072 keys a rank, and
    the sharded decode against the replicated one at LONG_PARITY_S.
    Returns the phase's numbers and launches."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.interop import stack_shards
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import layers
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    cfg = configs.get(LONG_ARCH)
    mesh = RankMesh(*LONG_MESH)
    data = mesh.shape["data"]
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True,
                                 fsdp_params=False)
    L, n_app = cfg.num_layers, cfg.num_layers // cfg.attn_every
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev,
                             rules=rules_for_ctx(pctx))
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    dctx = DiompContext(mesh=mesh, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)

    def run(S, steps, tokens=None, sharded=True, fill=None, weights=None,
            dt=torch.bfloat16):
        """Prefill the prompt into a fresh cache of S rows, fill rows
        [REC_PROMPT, S - LONG_TAIL), decode ``steps`` tokens from pos = S -
        LONG_TAIL (greedy, or ``tokens`` teacher-forced), with the model's
        weights (or ``weights``) and a cache of dtype ``dt``; returns
        (logits a step, event ms a step, the built decode step, the
        cache)."""
        weights = params if weights is None else weights
        pre = build_prefill_step(cfg, mesh, pctx, B=1, S_cache=S,
                                 seq_sharded=sharded)
        dec = build_decode_step(cfg, mesh, pctx, B=1, S=S,
                                seq_sharded=sharded)
        cache = _zero_cache(torch, cfg, mesh, pctx, 1, S, dt, dev,
                            seq_sharded=sharded)
        prompt = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                  (1, REC_PROMPT))
        with use_default(dctx):
            logits, cache = pre(weights, stack_shards(
                prompt, mesh, pre.token_spec, device=dev,
                dtype=torch.int64), cache)
            for name in ("k", "v"):
                _fill_rows(torch, cache[name], sharded, REC_PROMPT,
                           S - LONG_TAIL, g,
                           None if fill is None else fill[name].to(dt))
            cache["pos"].fill_(S - LONG_TAIL)
            nxt, toks = _greedy(torch, logits, pre, mesh, dev)
            out, events = [], []
            for i in range(steps):
                if tokens is not None:
                    toks = stack_shards(tokens[:, i:i + 1], mesh,
                                        dec.token_spec, device=dev,
                                        dtype=torch.int64)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                logits, cache = dec(weights, toks, cache)
                e1.record()
                events.append((e0, e1))
                out.append(logits)
                if tokens is None:
                    nxt, toks = _greedy(torch, logits, dec, mesh, dev)
        torch.cuda.synchronize()
        return out, [a.elapsed_time(b) for a, b in events], dec, cache

    # the long decode: a warm-up of two steps off the record, then the run
    run(LONG_PARITY_S, 2)
    torch.cuda.synchronize()
    parts, shapes = [], set()

    def keep(args, kw):
        q, kk = args[:2]
        shapes.add((q.shape[-1], kk.shape[-3], q.shape[-2] // kk.shape[-2],
                    kw.get("causal"), kw.get("return_lse")))
        if not parts:
            parts.append((args, kw))
        return False

    with _Tap(layers, "flash_attention_kernel", keep):
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        logits, steps_ms, dec, cache = run(LONG_S, LONG_NEW)
        wall = time.perf_counter() - t0
        launches = {name: wr.launches for name, wr in wrappers.items()}
        scan_routes = dict(wrappers["linear_scan"].route_launches)
        routes = _attention_routes(wrappers, "long")
    peak = torch.cuda.max_memory_allocated() / 1e9
    kv = sum(cache[n].numel() * cache[n].element_size() for n in ("k", "v"))
    log(f"long: {cfg.name} at full width and depth on {mesh.shape}, "
        f"{nbytes / 1e9:.2f} GB of weights (replicated over data), a "
        f"{LONG_S}-row cache ({LONG_S // data} rows a rank, "
        f"{kv / 1e9:.2f} GB of K/V); a {REC_PROMPT}-token prompt, then "
        f"{LONG_NEW} greedy steps from pos {LONG_S - LONG_TAIL} in "
        f"{wall:.1f} s; launches {launches}; flash calls (D, keys a rank, G, "
        f"causal, lse) {sorted(shapes)}; peak {peak:.1f} GB")
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    check(finite and int(cache["pos"].reshape(-1)[0]) == LONG_S - LONG_TAIL
          + LONG_NEW, "long: non-finite logits or a wrong position")
    # every decode step's attention: the cp partial on the tensor cores
    # (the prefill call's n_app launches are the prompt's causal flash)
    check(launches["flash_attention"] == n_app * (1 + LONG_NEW)
          and routes["flash_attention"]["wgmma"] == n_app * (1 + LONG_NEW)
          and wrappers["flash_attention"].combine_launches == 0
          and (cfg.head_dim, LONG_S // data, 1, False, True) in shapes,
          f"long: flash launches {launches['flash_attention']}, routes "
          f"{routes}, shapes {shapes}")
    check(launches["linear_scan"] == L * (1 + LONG_NEW)
          and scan_routes == {"prefill": L, "decode": L * LONG_NEW},
          f"long: linear_scan launches {launches['linear_scan']}, routes "
          f"{scan_routes}")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("linear_scan", "flash_attention")),
          f"long: unexpected launches {launches}")
    steady = steps_ms[2:]
    _, dec_b = _recurrent_bounds(cfg, sch.build_schema(cfg), 1, REC_PROMPT,
                                 LONG_S - LONG_TAIL + LONG_NEW // 2)
    med = statistics.median(steady)
    log(f"long: decode step median {med:.3f} ms over {len(steady)} steps "
        f"(min {min(steady):.3f}, max {max(steady):.3f}); bound "
        f"{dec_b[0]:.3f} ms by {dec_b[1]}; step over bound "
        f"{med / dec_b[0]:.2f}")
    toks = stack_shards(np.zeros((1, 1), np.int64), mesh, dec.token_spec,
                        device=dev, dtype=torch.int64)

    def decode_once():
        dec(params, toks, cache)

    with use_default(dctx):
        breakdown = _breakdown(torch, decode_once)
    log(f"long: decode step: {breakdown}")
    res = {"launches": launches["flash_attention"],
           "scan_launches": launches["linear_scan"],
           "routes": routes["flash_attention"], "step_ms": steps_ms,
           "step_median_ms": med, "bound_ms": dec_b[0],
           "bound_by": dec_b[1], "peak_memory_gb": peak,
           "kv_gb": kv / 1e9, "breakdown": breakdown}
    (args, kw), = parts
    res["cp_partial"] = _cp_partial_at(torch, k, args, kw)
    del parts, args, kw, cache, logits
    torch.cuda.empty_cache()

    # sharded == replicated at LONG_PARITY_S on the same filled rows and
    # teacher-forced tokens.  In f32 (weights and caches) the two decodes
    # differ by the order of f32 sums alone: within 1e-4 of the logits'
    # scale over every step (the partials on the CUDA cores).  In bf16 the
    # first decode call's first shared-block attention sees the same
    # inputs in both and must agree within 1.6e-2 of its scale (one bf16
    # rounding of each rank's partial plus the order; the partials on the
    # tensor cores); its logits are logged, not held: with random weights
    # that rounding grows through the 38 layers and 6 applications (on an
    # H100, to several percent of the logits' scale at the first step), past
    # the reference's 2e-2, which holds on its reduced config
    # (tests/test_torch_cp_decode.py)
    S = LONG_PARITY_S
    kv_shape = (mesh.shape["model"], n_app, 1, S - LONG_TAIL - REC_PROMPT,
                cfg.kv_heads // mesh.shape["model"], cfg.head_dim)
    fill = {n: torch.randn(*kv_shape, generator=g, device=dev)
            for n in ("k", "v")}
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size,
                                              (1, LONG_PARITY_NEW))
    first = {}

    def capture(name):
        orig = getattr(layers, name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            if args[0].shape[-3] == 1:
                first.setdefault(name, out.float())
            return out
        return _Swap(layers, name, call)

    with capture("cp_decode_attention"):
        got, *_ = run(S, LONG_PARITY_NEW, tokens, sharded=True, fill=fill)
    with capture("flash_attention"):
        want, *_ = run(S, LONG_PARITY_NEW, tokens, sharded=False, fill=fill)
    a_got, a_want = first["cp_decode_attention"], first["flash_attention"]
    a_rel = max_err(torch, a_got, a_want) / float(a_want.abs().max())
    bf16_rel = [max_err(torch, x, y) / float(y.abs().max())
                for x, y in zip(got, want)]
    check(a_rel <= 1.6e-2, f"long: the first cp attention differs from the "
          f"replicated flash call by {a_rel} (relative) at S = {S}")
    del got, want, first, a_got, a_want
    torch.cuda.empty_cache()
    p32 = {n: t.float() for n, t in params.items()}
    got, *_ = run(S, LONG_PARITY_NEW, tokens, sharded=True, fill=fill,
                  weights=p32, dt=torch.float32)
    want, *_ = run(S, LONG_PARITY_NEW, tokens, sharded=False, fill=fill,
                   weights=p32, dt=torch.float32)
    rel = max(max_err(torch, a, b) / float(b.abs().max())
              for a, b in zip(got, want))
    check(rel <= 1e-4, f"long: the f32 sharded decode differs from the "
          f"replicated one by {rel} (relative) at S = {S}")
    log(f"long: sharded == replicated decode at S = {S} over "
        f"{LONG_PARITY_NEW} teacher-forced steps: f32 logits within "
        f"{rel:.3g} of their scale (bound 1e-4); bf16 first attention call "
        f"{a_rel:.3g} (bound 1.6e-2), bf16 logits by step (not held) "
        f"{[round(x, 4) for x in bf16_rel]}")
    res["parity_bf16_attention_rel"] = a_rel
    res["parity_bf16_logits_rel"] = bf16_rel
    res["parity_f32_rel"] = rel
    del fill, got, want, params, p32
    torch.cuda.empty_cache()
    return res


# -- the audio family: hubert-xlarge's encoder and masked-frame training ----


def _attention_calls(shapes, calls=None):
    """A tap on the model stack's flash attention: each call's (D, Dv, G,
    causal) goes into the set ``shapes`` and the first call's arguments
    into ``calls`` (a training forward's backward inherits its flag)."""
    from repro_torch.models import layers

    def keep(args, kw):
        q, kk, v = args[:3]
        shapes.add((q.shape[-1], v.shape[-1], q.shape[-2] // kk.shape[-2],
                    kw.get("causal", True)))
        if calls is not None and not calls:
            calls.append((args, kw))
        return False

    return _Tap(layers, "flash_attention", keep)


def _encoder_bound(cfg, B, T):
    """The least device time (ms) of the encoder's forward over ``B x T``
    frames: two operations a layer-matrix weight a frame (the unread
    ``w_gate`` left out) and the attention's two products over every (query,
    key) pair, at the bf16 rate; the weights read once."""
    from repro_torch.models import schema as sch
    spec = sch.build_schema(cfg)
    w = _layer_matrix_weights(cfg, spec)
    ops = 2 * w * B * T + 2 * 2 * cfg.num_layers * cfg.num_heads \
        * cfg.head_dim * _attn_pairs(T, False) * B
    return bound(2 * w + 2 * B * T * cfg.d_model * 2, ops, "bfloat16")


def audio_phase(torch, k, dev, wrappers) -> dict:
    """hubert-xlarge at full width and depth: the encoder's forward over
    AUDIO_FWD_BATCH x AUDIO_FWD_FRAMES frames under inference on data 2 x
    model 2, then the launcher's TRAIN_STEPS masked-frame steps of
    TRAIN_BATCH x TRAIN_SEQ frames (microbatch TRAIN_MICRO, remat, AdamW)
    under each of AUDIO_LAYOUTS, every wrapper's count zeroed just before
    and read just after each; every attention forward and backward must
    run on the tensor cores at (80, 80, G = 1), non-causal.  Then, at depth
    2: the kernels' step against the plain versions' step, and the first
    loss under dp_only against the tp layout's on the same weights and
    batch.  Returns the phase's numbers and launches."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.interop import stack_shards
    from repro_torch.kernels.flash_attention import kernel as fa_mod
    from repro_torch.launch import train as launcher
    from repro_torch.models import api
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    from repro_torch.models.transformer import transformer_forward
    from repro_torch.train.step import per_rank_grads

    cfg = configs.get(AUDIO_ARCH)
    mesh = launcher.parse_mesh(TRAIN_MESH)
    want_shape = (cfg.head_dim, cfg.head_dim, 1, False)
    res = {"params": cfg.param_count()}
    torch.cuda.empty_cache()

    # 1. the encoder's forward (its "prefill", as the reference lowers it)
    pctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    params = sch.init_params(cfg, mesh, torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    structs, bspecs = api.batch_structs(cfg, mesh, AUDIO_FWD_BATCH,
                                        AUDIO_FWD_FRAMES)
    frames = np.random.RandomState(0).randn(
        AUDIO_FWD_BATCH, AUDIO_FWD_FRAMES, cfg.d_model).astype(np.float32)
    x = stack_shards(frames, mesh, bspecs["embeds"], device=dev,
                     dtype=structs["embeds"].dtype)
    dctx = DiompContext(mesh=mesh, device=dev)
    shapes, calls = set(), []

    def forward():
        with torch.no_grad():
            return transformer_forward(params, None, cfg, pctx, embeds=x)[0]

    with use_default(dctx):
        forward()                                       # warm-up
        torch.cuda.synchronize()
        with _attention_calls(shapes, calls):
            _zero_counts(wrappers)
            h = forward()
            torch.cuda.synchronize()
            launches = {n: w.launches for n, w in wrappers.items()}
            routes = _attention_routes(wrappers, "audio forward")
        fwd_ms = [cuda_ms(torch, forward, 1, warmup=0) for _ in range(3)]
    b_ms, b_by = _encoder_bound(cfg, AUDIO_FWD_BATCH, AUDIO_FWD_FRAMES)
    check(h.shape[-3:] == (AUDIO_FWD_BATCH // mesh.shape["data"],
                           AUDIO_FWD_FRAMES, cfg.d_model)
          and bool(torch.isfinite(h).all()), "audio: bad hidden states")
    check(launches["flash_attention"] == cfg.num_layers
          and routes["flash_attention"]["wgmma"] == cfg.num_layers
          and shapes == {want_shape}
          and all(n == 0 for name, n in launches.items()
                  if name != "flash_attention"),
          f"audio forward: launches {launches}, flash shapes {shapes}")
    log(f"audio: {cfg.name} ({res['params']} parameters) encoder forward "
        f"over {AUDIO_FWD_BATCH} x {AUDIO_FWD_FRAMES} frames on "
        f"{mesh.shape}: {', '.join(f'{t:.2f}' for t in fwd_ms)} ms (bound "
        f"{b_ms:.3f} ms by {b_by}); flash launches "
        f"{launches['flash_attention']}, shapes {sorted(shapes)}")
    res["forward"] = {"ms": fwd_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "launches": launches["flash_attention"]}
    (args, kw), = calls
    res["flash_forward"] = _flash_call(torch, k, "hubert encoder", args, kw)
    del calls, args, kw, h, x, params
    torch.cuda.empty_cache()

    # 2. training through the launcher under each layout
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_pass = cfg.num_layers * TRAIN_MICRO * TRAIN_STEPS
    t_bound = _train_flops(cfg, tokens) / PEAK_OPS["bfloat16"] * 1e3
    res["train"] = {}
    for layout in AUDIO_LAYOUTS:
        argv = ["--arch", AUDIO_ARCH, "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--microbatch", str(TRAIN_MICRO), "--mesh", TRAIN_MESH,
                "--layout", layout, "--device", str(torch.device(dev).type)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shapes = set()
        with _attention_calls(shapes):
            _zero_counts(wrappers)
            t0 = time.perf_counter()
            run = launcher.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fwd, bwd = (wrappers[n] for n in ("flash_attention",
                                              "flash_attention_bwd"))
            counts = {"forward": fwd.launches, "forward_routes": dict(
                fwd.route_launches), "backward": bwd.launches,
                "backward_routes": dict(bwd.route_launches)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = [{"ms": x * 1e3, "tokens_per_s": tokens / x}
                 for x in run["step_s"]]
        log(f"audio train ({layout}): {TRAIN_STEPS} steps of {TRAIN_BATCH} "
            f"x {TRAIN_SEQ} frames in {wall:.1f} s; losses {run['losses']}, "
            f"grad norms {run['grad_norms']}; step ms "
            f"{[round(x['ms'], 2) for x in steps]}, frames/s "
            f"{[round(x['tokens_per_s'], 1) for x in steps]}; bound "
            f"{t_bound:.2f} ms a step; flash {counts}, shapes "
            f"{sorted(shapes)}; peak {peak:.2f} GB")
        check(all(math.isfinite(v) for v in run["losses"]
                  + run["grad_norms"]) and len(run["losses"]) == TRAIN_STEPS,
              f"audio train ({layout}): a non-finite step")
        check(counts["forward"] == 2 * per_pass
              and counts["forward_routes"] == {"simt": 0,
                                               "wgmma": 2 * per_pass}
              and counts["backward"] == per_pass
              and counts["backward_routes"] == {"simt": 0, "wgmma": per_pass}
              and shapes == {want_shape},
              f"audio train ({layout}): flash {counts}, shapes {shapes}")
        res["train"][layout] = {"step_ms": steps, "bound_ms": t_bound,
                                "peak_memory_gb": peak, "flash": counts,
                                "losses": run["losses"]}
        del run
    torch.cuda.empty_cache()

    # 3. at depth 2: kernels against the plain versions, dp_only against tp
    small = _cut(cfg, TRAIN_CUT_LAYERS)
    dctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 26)
    out = {}
    with use_default(dctx):
        ctx, opt, step, batch = _train_setup(torch, dev, small, mesh)
        params = sch.init_params(small, mesh, torch.Generator(device=dev)
                                 .manual_seed(1), device=dev)
        b0, st0, nd = batch(0), opt.init(params), mesh.ndim
        _zero_counts(wrappers)
        _, st, met_k = step(params, st0, b0, 0)
        check(wrappers["flash_attention_bwd"].route_launches["simt"] == 0
              and wrappers["flash_attention"].route_launches["simt"] == 0,
              "audio checks: an attention launch left the tensor cores")
        r_k = _step_grads(torch, st, met_k, nd)
        saved = (fa_mod.flash_attention_kernel,
                 fa_mod.flash_attention_bwd_kernel)
        fa_mod.flash_attention_kernel = fa_mod.flash_attention_plain
        fa_mod.flash_attention_bwd_kernel = fa_mod.flash_attention_bwd_plain
        try:
            _, st, met_p = step(params, st0, b0, 0)
            r_p = _step_grads(torch, st, met_p, nd)
            l_p, g_p = per_rank_grads(params, b0, small, ctx, mesh)
        finally:
            fa_mod.flash_attention_kernel, fa_mod.flash_attention_bwd_kernel \
                = saved
        loss_err = float((met_k["loss"] - met_p["loss"]).abs().max()
                         / met_p["loss"].abs().max())
        g_scale = {n: max(float(g_p[n].float().abs().max()), 1e-30)
                   for n in g_p}
        check(loss_err <= 1e-3, f"audio: kernels vs plain loss {loss_err}")
        out["kernels_vs_plain"] = {
            "loss_rel": loss_err,
            "step_grad_rel": _grads_close(torch, r_k, r_p, 2e-2,
                                          "audio: kernels vs plain step",
                                          scale=g_scale)}
        del r_k, r_p, g_p, st
        # the same global weights and batch under dp_only
        from repro_torch.distributed.sharding import rules_for_ctx
        ctx_d, _, step_d, batch_d = _train_setup(torch, dev, small, mesh,
                                                 layout="dp_only")
        tp_specs = sch.partition_specs(small, mesh)
        dp_specs = sch.partition_specs(small, mesh, rules_for_ctx(ctx_d))
        p_d = launcher.from_global(launcher.to_global(params, tp_specs, mesh),
                                   dp_specs, mesh, dev)
        _, _, met_d = step_d(p_d, opt.init(p_d), batch_d(0), 0)
        d_err = float((met_d["loss"] - met_k["loss"]).abs().max()
                      / met_k["loss"].abs().max())
        # each rank's loss is its own frames' masked mean, so the two
        # layouts average over other groupings of the same frames: within
        # bf16's rounding of the loss
        check(d_err <= BF16_U, f"audio: dp_only first loss differs from "
              f"tp's by {d_err} (relative)")
        out["dp_only_vs_tp_loss_rel"] = d_err
        del p_d, params
    log("audio checks: " + json.dumps(out))
    res["checks"] = out
    torch.cuda.empty_cache()

    # 4. the backward kernel at one layer's training shape, non-causal:
    # (ranks 2 x 2, a microbatch of 2, TRAIN_SEQ frames, 8 heads of 80)
    g = torch.Generator(device=dev).manual_seed(4)
    shape = (2, 2, TRAIN_BATCH // 2 // TRAIN_MICRO, TRAIN_SEQ,
             cfg.num_heads // mesh.shape["model"], cfg.head_dim)
    q, kk, v, do = (torch.randn(*shape, generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(4))
    res["bwd"] = _bwd_at(torch, k, q, kk, v, do, causal=False)
    del q, kk, v, do
    torch.cuda.empty_cache()
    return res


# -- fault injection: the fused kernels, the engine and the launcher ----------

# a chaos run's plan: transient faults at CHAOS_P a dispatch, retried without
# sleeping; a calm run's plan is inert.  Every path starts a fresh plan, so
# every path's stream is the seed's from call 0: seed 36 faults the first
# put (and its first retry) and the first halo exchange, so that the host
# Minimod run, whose one recorded step rolls one halo exchange, injects too
CHAOS_SEED, CHAOS_P, CHAOS_KINDS = 36, 0.3, ("drop", "fail", "timeout")
CHAOS_ROUNDS = 2                # calm / chaos pairs a path (host times: min)
# glm4-9b's rank death: DEATH_REQUESTS prompts of DEATH_MIN..DEATH_MAX
# tokens, DEATH_NEW new tokens each, on DEATH_SLOTS slots in chunks of
# CHUNK; the graceful death of rank 0 at engine step DEATH_STEP
# (mid-decode), the abrupt one after ABRUPT_AFTER steps
DEATH_REQUESTS, DEATH_MIN, DEATH_MAX, DEATH_NEW = 4, 256, 1024, 8
DEATH_SLOTS, DEATH_MAX_LEN, DEATH_STEP, ABRUPT_AFTER = 2, 2048, 4, 5
# stablelm-3b under chaos: TRAIN_CUT_LAYERS at full width on TRAIN_MESH,
# CHAOS_TRAIN_STEPS steps; the elastic run's death after step ELASTIC_KILL,
# so the restored optimizer state drives a step whose loss is read.  Its
# losses are held at ELASTIC_LOSS_TOL of the uninterrupted run's and each
# final parameter tensor at ELASTIC_PARAM_TOL (relative Frobenius norm):
# the restored run reduces over half the ranks, a gap in the order of
# reduction, where a restore that zeroes the optimizer state or skips the
# resumed step moves some tensor by 1e-2 or more (the reduced config's
# test_elastic_restore_parameters_tell_a_broken_restore); a zeroed state
# barely moves the final loss, so the parameters are what tells it
CHAOS_TRAIN_STEPS, ELASTIC_KILL = 4, 1
ELASTIC_LOSS_TOL, ELASTIC_PARAM_TOL = 1e-4, 5e-3
CHAOS = {}              # path -> its chaos record (logged, and in the line)
CHAOS_LAUNCHES = {}     # kernel -> its launches in the chaos phase's runs


def _outputs(out) -> list:
    """The tensors of a path's output, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return [] if out is None else [out]


def _total(stats) -> int:
    return sum(sum(ops.values()) for ops in stats.values())


def _chaos_plans():
    """(calm plan, chaos plan, retry policy) for one calm / chaos pair."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.resilience import RetryPolicy
    return (FaultPlan(0, p=0.0),
            FaultPlan(CHAOS_SEED, p=CHAOS_P, kinds=CHAOS_KINDS),
            RetryPolicy(sleep=False))


def _in_context(mesh, dev, call):
    """A path that runs ``call()`` inside a fresh context on ``mesh``: its
    books are the context's call and byte logs and the RMA tracker's."""
    from repro_torch.core.context import DiompContext, use_default

    def run(plan, policy):
        ctx = DiompContext(mesh=mesh, device=dev, fault_plan=plan,
                           retry_policy=policy)
        with use_default(ctx):
            out = call()
        books = (ctx.stats(), ctx.byte_stats(), ctx.rma.puts,
                 ctx.rma.put_bytes, ctx.rma.fences,
                 dict(ctx.rma.window_bytes))
        return (out, books, _total(ctx.retry_stats()),
                _total(ctx.retry_byte_stats()))
    return run


def _chaos_path(torch, path, wrappers, names, run) -> dict:
    """``run(plan, policy)`` drives one path and returns ``(output, books,
    retries, retry bytes)``.  CHAOS_ROUNDS times, a calm run and a chaos
    run: every output equal to the first calm run's bit for bit, the books
    and each of ``names``' launches and routes equal to the calm run's
    (and not zero), faults injected, every one recovered by one retry.
    Records the injected counts by kind, the retries and their bytes, and
    the least host time of each kind of run."""
    first, times = None, {"calm": [], "chaos": []}
    for _ in range(CHAOS_ROUNDS):
        calm_plan, plan, policy = _chaos_plans()
        seen = {}
        for kind, fp in (("calm", calm_plan), ("chaos", plan)):
            before = {n: (wrappers[n].launches,
                          dict(getattr(wrappers[n], "route_launches", {})))
                      for n in names}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, books, retries, rbytes = run(fp, policy)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            counts = {n: (wrappers[n].launches - before[n][0],
                          {r: c - before[n][1][r] for r, c in
                           getattr(wrappers[n], "route_launches", {}).items()})
                      for n in names}
            for n, (c, _) in counts.items():
                CHAOS_LAUNCHES[n] = CHAOS_LAUNCHES.get(n, 0) + c
            outs = _outputs(out)
            if first is None:
                first = outs
            check(len(outs) == len(first)
                  and all(torch.equal(a, b) for a, b in zip(outs, first)),
                  f"chaos {path}: a {kind} run's output differs from the "
                  "first calm run's")
            seen[kind] = (books, counts, retries, rbytes)
            del out, outs
        (c_books, c_counts, c_retries, _), (books, counts, retries, rbytes) \
            = seen["calm"], seen["chaos"]
        check(books == c_books, f"chaos {path}: logical logs differ from "
              f"the calm run's: {books} vs {c_books}")
        check(counts == c_counts and all(c > 0 for c, _ in counts.values()),
              f"chaos {path}: launches {counts}, calm {c_counts}")
        check(c_retries == 0 and calm_plan.injected == [],
              f"chaos {path}: the calm run retried {c_retries}")
        check(len(plan.injected) > 0 and plan.unrecovered() == []
              and retries == len(plan.injected),
              f"chaos {path}: {len(plan.injected)} injected, "
              f"{len(plan.unrecovered())} unrecovered, {retries} retries")
    del first
    rec = {"injected": plan.injected_counts(), "faults": len(plan.injected),
           "retries": retries, "retry_bytes": rbytes,
           "calm_s": min(times["calm"]), "chaos_s": min(times["chaos"]),
           "launches": {n: c for n, (c, _) in counts.items()}}
    CHAOS[path] = rec
    log(f"chaos {path}: injected {rec['injected']} ({rec['faults']} faults, "
        f"{retries} retries, {rbytes} retry bytes a rank), outputs, logs and "
        f"launches {rec['launches']} equal to the calm run's; host "
        f"{rec['chaos_s']:.6f} s against calm {rec['calm_s']:.6f} s "
        f"(least of {CHAOS_ROUNDS})")
    return rec


def chaos_main_path(torch, k, dev, wrappers, x, w, u0, up0) -> None:
    """Rows 1-4 under chaos at the main path's sizes: the fused ring (its
    kernel route's puts logged and rolled before the launch) and the host
    ring (``ompx_put``) at N = 30240, and Minimod at 1024³ fused (carried)
    and host."""
    from repro_torch.apps.minimod import run_minimod
    from repro_torch.core.groups import DiompGroup
    from repro_torch.kernels.ring_matmul.ops import ring_allgather_matmul
    from repro_torch.launch.mesh import RankMesh

    mesh, ring = RankMesh(("ring",), (RING_RANKS,)), DiompGroup(("ring",),
                                                                name="ring")
    for impl, name in (("fused", "fused_ring_allgather_matmul"),
                       ("host", "matmul")):
        _chaos_path(torch, f"ring {impl}", wrappers, [name], _in_context(
            mesh, dev, lambda impl=impl: ring_allgather_matmul(
                x, w, ring, impl=impl)))
        torch.cuda.empty_cache()
    for mode, name in (("fused", "fused_wave_step"), ("host", "wave_step")):
        def run(plan, policy, mode=mode):
            r = run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS, mode=mode,
                            u0=u0, u_prev0=up0, device=dev, fault_plan=plan,
                            retry_policy=policy)
            books = {a: getattr(r, a) for a in MINIMOD_COUNTERS}
            return r.field, books, r.retries, r.retry_bytes
        _chaos_path(torch, f"minimod {mode}", wrappers, [name], run)
        torch.cuda.empty_cache()


def rank_death_runs(torch, dev, cfg, mesh, pctx, params, wrappers) -> dict:
    """glm4-9b at full width and depth on the serving phase's weights:
    DEATH_REQUESTS requests served undisturbed, through a graceful death of
    rank 0 at engine step DEATH_STEP (a ``FaultPlan``), and through an
    abrupt one after ABRUPT_AFTER steps; tokens equal to the undisturbed
    run's, the page ledger balanced, the drain's page transfers validated
    under the plan, flash counted on every run."""
    import numpy as np
    from repro_torch.core.context import DiompContext
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.resilience import RetryPolicy
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.RandomState(CHAOS_SEED)
    lengths = rng.randint(DEATH_MIN, DEATH_MAX + 1, size=DEATH_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lengths]
    flash = wrappers["flash_attention"]

    def serve(plan, abrupt=False):
        ctx = DiompContext(mesh=mesh, device=dev, segment_bytes=1 << 31,
                           allocator="buddy", fault_plan=plan,
                           retry_policy=RetryPolicy(sleep=False))
        eng = ServeEngine(cfg, mesh, pctx, params, context=ctx,
                          page_tokens=PAGE_TOKENS, slots=DEATH_SLOTS,
                          max_len=DEATH_MAX_LEN, prefill_chunk=CHUNK)
        n0 = flash.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=DEATH_NEW) for p in prompts]
        homed = []
        if abrupt:
            for _ in range(ABRUPT_AFTER):
                eng.step()
            homed = [r for r in eng.active.values() if r.kv is not None
                     and r.kv.home_rank == 0 and r.kv.page_table]
            check(len(homed) > 0, "abrupt death: no request's pages are "
                  "homed on rank 0")
            eng.on_rank_death(0, graceful=False)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash.launches - n0
        CHAOS_LAUNCHES["flash_attention"] = \
            CHAOS_LAUNCHES.get("flash_attention", 0) + launches
        check(all(r.done and len(r.out) == DEATH_NEW for r in reqs)
              and launches > 0, "rank death: a request unfinished")
        return eng, [r.out for r in reqs], launches, wall, len(homed)

    out = {}
    eng, want, launches, wall, _ = serve(FaultPlan(0, p=0.0))
    out["undisturbed"] = {"flash_launches": launches, "s": wall,
                          "kv": dict(eng.kv_stats)}
    del eng
    plan = FaultPlan(0, p=0.0).kill_rank(DEATH_STEP, rank=0, graceful=True)
    eng, got, launches, wall, _ = serve(plan)
    (step, rank, graceful, drained, lost), = eng.rank_death_log
    kv = eng.kv_stats
    gets = eng.dctx.stats()[eng._group.descriptor()].get("get", 0)
    check(got == want, f"graceful death: tokens {got} != undisturbed {want}")
    check(graceful and rank == 0 and drained > 0 and lost == 0,
          f"graceful death: log {eng.rank_death_log}")
    check(kv["pages_allocated"] == kv["pages_freed"] > 0
          and kv["pages_lost"] == 0, f"graceful death: ledger {kv}")
    # every page transfer of the drain went through the validated migrate:
    # one "migrate" roll of the plan and one fenced, checked put a page
    check(plan._counters.get("migrate", 0) == gets > 0
          and eng.alloc.stats["migrations"] > 0,
          f"graceful death: {plan._counters.get('migrate', 0)} migrate "
          f"rolls for {gets} page gets")
    out["graceful"] = {"step": step, "drained_bytes": drained,
                       "pages_validated": gets, "flash_launches": launches,
                       "s": wall, "kv": dict(kv)}
    del eng
    eng, got, launches, wall, homed = serve(FaultPlan(0, p=0.0), abrupt=True)
    kv, st = eng.kv_stats, eng.latency_stats()
    check(got == want, f"abrupt death: tokens {got} != undisturbed {want}")
    check(st["requeued"] >= homed and st["live_ranks"] == 1,
          f"abrupt death: requeued {st['requeued']} of {homed} homed")
    check(kv["pages_lost"] > 0
          and kv["pages_allocated"] == kv["pages_freed"],
          f"abrupt death: ledger {kv}")
    out["abrupt"] = {"homed": homed, "requeued": st["requeued"],
                     "log": eng.rank_death_log[0][:5],
                     "flash_launches": launches, "s": wall, "kv": dict(kv)}
    del eng
    CHAOS["glm4-9b rank death"] = out
    log(f"rank death: glm4-9b, {DEATH_REQUESTS} requests (prompts "
        f"{sorted(lengths.tolist())}, {DEATH_NEW} new tokens, {DEATH_SLOTS} "
        f"slots): {json.dumps(out)}; tokens equal to the undisturbed run's")
    return out


def _global_params(torch, launcher, cfg, run) -> dict:
    """A launcher run's final parameters as global float64 CPU tensors."""
    from repro_torch.distributed.sharding import rules_for_ctx
    from repro_torch.models import schema as sch
    from repro_torch.models.config import ParallelCtx
    mesh = run["mesh"]
    specs = sch.partition_specs(cfg, mesh,
                                rules_for_ctx(ParallelCtx.from_mesh(mesh)))
    return {n: t.to(torch.float64) for n, t in
            launcher.to_global(run["params"], specs, mesh).items()}


def train_chaos_phase(torch, k, dev, wrappers) -> dict:
    """stablelm-3b at full width, depth TRAIN_CUT_LAYERS, on TRAIN_MESH
    through the launcher as a user runs it, its retry policy its own:
    CHAOS_TRAIN_STEPS steps calm and under ``--chaos-seed`` (losses,
    gradient norms, final parameters bit for bit, logical logs equal, one
    retry a fault, rows 5 and 10 on the tensor cores in both), then with
    ``--kill-rank-step ELASTIC_KILL``: one elastic restore onto half the
    ranks, each loss within ELASTIC_LOSS_TOL and each final parameter
    within ELASTIC_PARAM_TOL of the uninterrupted run's, and the final
    loss within the reference's 5e-2."""
    import shutil
    from repro_torch import configs
    from repro_torch.launch import train as launcher

    cfg = _cut(configs.get(TRAIN_ARCH), TRAIN_CUT_LAYERS)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(CHAOS_TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatch", str(TRAIN_MICRO), "--mesh", TRAIN_MESH,
            "--device", str(torch.device(dev).type)]
    chaos = ["--chaos-seed", str(CHAOS_SEED), "--chaos-p", str(CHAOS_P)]
    ckpt_dir = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fwd, bwd = wrappers["flash_attention"], wrappers["flash_attention_bwd"]
    runs = {}
    for name, extra in (("calm", []), ("chaos", chaos),
                        ("elastic", chaos + [
                            "--kill-rank-step", str(ELASTIC_KILL),
                            "--max-restarts", "1", "--checkpoint-dir",
                            str(ckpt_dir), "--checkpoint-every",
                            str(CHAOS_TRAIN_STEPS + 1)])):
        torch.cuda.empty_cache()
        _zero_counts(wrappers)
        t0 = time.perf_counter()
        run = launcher.main(argv + extra, cfg=cfg)
        torch.cuda.synchronize()
        run["s"] = time.perf_counter() - t0
        run["flash"] = {"forward": fwd.launches, "forward_routes": dict(
            fwd.route_launches), "backward": bwd.launches,
            "backward_routes": dict(bwd.route_launches)}
        for name_k, n in (("flash_attention", fwd.launches),
                          ("flash_attention_bwd", bwd.launches)):
            CHAOS_LAUNCHES[name_k] = CHAOS_LAUNCHES.get(name_k, 0) + n
        runs[name] = run
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    calm, hit, el = runs["calm"], runs["chaos"], runs["elastic"]
    plan = hit["context"].fault_plan
    retries = _total(hit["context"].retry_stats())
    per_pass = cfg.num_layers * TRAIN_MICRO * CHAOS_TRAIN_STEPS
    for name in ("calm", "chaos"):
        f = runs[name]["flash"]
        check(f["forward"] == 2 * per_pass and f["backward"] == per_pass
              and f["forward_routes"]["simt"] == 0
              and f["backward_routes"]["simt"] == 0,
              f"train chaos: {name} run's flash launches {f}")
    check(hit["flash"] == calm["flash"], "train chaos: launches differ")
    check(hit["losses"] == calm["losses"]
          and hit["grad_norms"] == calm["grad_norms"],
          f"train chaos: losses {hit['losses']} / {calm['losses']}, norms "
          f"{hit['grad_norms']} / {calm['grad_norms']}")
    same = all(torch.equal(hit["params"][n], p)
               for n, p in calm["params"].items())
    check(same, "train chaos: final parameters differ from the calm run's")
    check(hit["context"].stats() == calm["context"].stats()
          and hit["context"].byte_stats() == calm["context"].byte_stats(),
          "train chaos: logical logs differ from the calm run's")
    check(len(plan.injected) > 0 and plan.unrecovered() == []
          and retries == len(plan.injected),
          f"train chaos: {len(plan.injected)} injected, {retries} retries")
    eplan = el["context"].fault_plan
    loss_gaps = [abs(a - b) for a, b in zip(el["losses"], calm["losses"])]
    want, got = (_global_params(torch, launcher, cfg, r) for r in (calm, el))
    param_gaps = {n: float((got[n] - p).norm() / p.norm())
                  for n, p in want.items()}
    del want, got
    param_gap = max(param_gaps.values())
    check(el["restarts"] == 1 and el["mesh"].size < calm["mesh"].size
          and [d.fired for d in eplan.deaths] == [True]
          and len(el["losses"]) == len(calm["losses"])
          and max(loss_gaps) <= ELASTIC_LOSS_TOL
          and abs(el["loss"] - calm["loss"]) <= 5e-2
          and param_gap <= ELASTIC_PARAM_TOL,
          f"elastic restore: restarts {el['restarts']}, mesh "
          f"{el['mesh'].shape}, losses {el['losses']} vs {calm['losses']}, "
          f"parameter gap {param_gap} (limit {ELASTIC_PARAM_TOL})")
    check(len(eplan.injected) > 0 and eplan.unrecovered() == [],
          "elastic restore: the restored run injected nothing")
    out = {"layers": cfg.num_layers, "mesh": TRAIN_MESH,
           "steps": CHAOS_TRAIN_STEPS, "losses": calm["losses"],
           "injected": plan.injected_counts(), "faults": len(plan.injected),
           "retries": retries,
           "retry_bytes": _total(hit["context"].retry_byte_stats()),
           "calm_s": calm["s"], "chaos_s": hit["s"],
           "step_s": {"calm": calm["step_s"], "chaos": hit["step_s"]},
           "flash": calm["flash"],
           "elastic": {"restarts": el["restarts"],
                       "mesh": dict(zip(el["mesh"].axis_names,
                                        el["mesh"].sizes)),
                       "loss": el["loss"], "uninterrupted": calm["loss"],
                       "loss_gaps": loss_gaps, "param_gap": param_gap,
                       "s": el["s"], "faults": len(eplan.injected)}}
    CHAOS["train stablelm-3b"] = out
    log(f"train chaos: {cfg.name} at depth {cfg.num_layers}: "
        f"{json.dumps(out)}")
    del runs, calm, hit, el
    torch.cuda.empty_cache()
    return out


# -- the multi-process phase: rows 1-4 driven from several processes ---------
# The main path's ring (N = 30240 bf16) and Minimod (1024^3 over nz = 4, 10
# steps, fused and host) at 1 x 4 (this process, no job), then in 2 and 4
# worker processes on the same card (2 x 2, 4 x 1: processes x ranks each),
# each joined over torch.distributed's gloo (``diomp.init(coordinator=...)``;
# a verb that crosses processes moves host copies staged through pinned
# memory).  Inputs come from one seed on every process, which keeps its box.
# Held: every rank's bytes of every output equal to the 1 x 4 run's, the
# logical logs (``gather_stats``) equal and equal on every process, each
# process's launches and routes of rows 1-4 as predicted, and at 2 x 2 the
# fused ring under a seeded chaos plan (drop, fail at MP_CHAOS_P) recovering
# every fault with the calm run's outputs and logical logs.  The 2 x 2
# workers also time the transport: the least of MP_LATENCY_REPS 8-byte
# exchanges, and one exchange of a ring stripe (t_loc x N bf16, 457 MB).
MP_SPLITS = ((2, 2), (4, 1))            # worker launches: processes x ranks
MP_TIMEOUT_S = 300                      # a launch's limit, start to results
MP_SEED, MP_CHAOS_SEED, MP_CHAOS_P = 7, 1234, 0.15
MP_LATENCY_REPS = 9
MP_DIR = ROOT / "build" / "chip_smoke_mp"
MP_ROWS = ("matmul", "fused_ring_allgather_matmul", "wave_step",
           "fused_wave_step")


def _mp_row_launches(ranks: int) -> dict:
    """A process's predicted launches of rows 1-4 for its ``ranks`` of the
    ring of RING_RANKS (and of Minimod's Z ring of NZ): the host ring's GEMM
    every step a rank; the fused ring one launch of row 2 when the process
    holds the ring, else its schedule's four GEMM steps a rank on row 1;
    Minimod one launch a step of row 4 (carried) and of row 3 (host)."""
    whole = ranks == RING_RANKS
    host = RING_RANKS * ranks
    fused = 0 if whole else 4 * ranks
    return {"matmul": host + fused,
            "fused_ring_allgather_matmul": 1 if whole else 0,
            "wave_step": STEPS, "fused_wave_step": STEPS}


def _mp_ring_inputs(torch, dev, mesh):
    """The ring's stacked operands from MP_SEED, generated rank by rank on
    every process (the same stream at every split); this process keeps
    its box."""
    g = torch.Generator(device=dev).manual_seed(MP_SEED)
    n, N = RING_RANKS, RING_N
    t_loc = n_loc = N // n
    scale = N ** -0.25
    mine = set(mesh.local_ranks)
    x, w = [], []
    for shape, keep in (((t_loc, N), x), ((N, n_loc), w)):
        for r in range(n):
            t = (torch.randn(*shape, generator=g, device=dev) * scale).to(
                torch.bfloat16)
            if r in mine:
                keep.append(t)
            del t
    return torch.stack(x), torch.stack(w)


def _mp_fields(torch, dev):
    """Minimod's initial fields from MP_SEED + 1, made on the card and
    kept whole on the host of every process (``run_minimod`` keeps its box
    on the card: four processes' whole fields would not fit there)."""
    g = torch.Generator(device=dev).manual_seed(MP_SEED + 1)
    return [(torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1).cpu()
            for _ in range(2)]


def _digests(torch, coord, pairs) -> list:
    """sha256 of each ``(rank, tensor)``'s host bytes, gathered over the job
    in rank order."""
    import hashlib

    mine = [[r, hashlib.sha256(t.contiguous().view(-1).view(torch.uint8)
                               .cpu().numpy().tobytes()).hexdigest()]
            for r, t in pairs]
    rows = sorted(row for part in coord.allgather(mine) for row in part)
    return [d for _, d in rows]


def _logical(ctx) -> dict:
    """gather_stats: whether every process's row is equal, and the logical
    part (retries left out) of this process's."""
    rows = ctx.gather_stats()
    canon = json.loads(json.dumps(
        [{k: v for k, v in r.items() if k != "process_id"} for r in rows]))
    mine = canon[0]
    rma = {k: v for k, v in mine["rma"].items()
           if k not in ("retry_puts", "retry_bytes")}
    return {"parity": all(r == mine for r in canon),
            "logical": json.loads(json.dumps(
                {k: mine[k] for k in ("stats", "byte_stats", "pgas")}
                | {"rma": rma}, sort_keys=True)),
            "retries": sum(sum(d.values())
                           for d in mine["retry_stats"].values())}


def _timed(torch, fn):
    """``fn()`` timed by CUDA events on this process's stream and by the
    host clock (s), the card synchronized around it."""
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    marks[0].record()
    out = fn()
    marks[1].record()
    torch.cuda.synchronize()
    return out, marks[0].elapsed_time(marks[1]), time.perf_counter() - t0


def _mp_run(torch, dev, wrappers, link: bool = False,
            chaos: bool = False) -> dict:
    """This process's part of the multi-process phase: both rings and both
    Minimod modes at the main path's sizes over the job's ranks (the whole
    ring in a process of no job), each timed, every rank's output bytes
    digested; the launches and routes of rows 1-4 counted from zero; the
    ring's logical logs; with ``link`` the transport's latency and
    bandwidth; with ``chaos`` the rings again under a seeded plan."""
    from repro_torch.apps.minimod import run_minimod
    from repro_torch.core import coordination
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.groups import DiompGroup
    from repro_torch.core.resilience import RetryPolicy
    from repro_torch.kernels.ring_matmul import fused as r_fused
    from repro_torch.kernels.ring_matmul.ops import ring_allgather_matmul
    from repro_torch.kernels.stencil import fused as s_fused
    from repro_torch.launch.mesh import RankMesh, make_process_mesh

    names = MP_ROWS
    coord = coordination.coordinator_for()
    mesh = make_process_mesh(shape=(RING_RANKS,), axes=("ring",)) \
        if coordination.is_distributed() else RankMesh(("ring",),
                                                       (RING_RANKS,))
    ring = DiompGroup(("ring",), name="ring")
    out = {"process_id": coord.process_id, "ranks": mesh.local_size}
    x, w = _mp_ring_inputs(torch, dev, mesh)
    zl = GRID // NZ

    def snap():
        """The counters of rows 1-4: launches, per route, and the fused
        entries' route choices."""
        return {"launches": {n: wrappers[n].launches for n in names},
                "route_launches": {n: dict(wrappers[n].route_launches)
                                   for n in names},
                "ring": dict(r_fused.fused_ring_allgather_matmul.routes),
                "step": dict(s_fused.fused_wave_step.routes)}

    def since(a, b):
        """``b - a`` of two snapshots, nonzero entries only for the
        routes' choices."""
        return {"launches": {n: b["launches"][n] - a["launches"][n]
                             for n in names},
                "route_launches": {n: {r: c - a["route_launches"][n][r]
                                       for r, c in
                                       b["route_launches"][n].items()}
                                   for n in names},
                "routes": {key: {r: c - a[key][r] for r, c in b[key].items()
                                 if c != a[key][r]}
                           for key in ("ring", "step")}}

    _zero_counts({n: wrappers[n] for n in names})
    start = snap()
    moved, sent = {}, [coordination.TRANSPORT["sent_bytes"]]

    def mark(what):
        """The bytes this process sent over the transport for ``what``."""
        moved[what] = coordination.TRANSPORT["sent_bytes"] - sent[0]
        sent[0] = coordination.TRANSPORT["sent_bytes"]

    def rings(plan=None):
        ctx = DiompContext(mesh=mesh, device=dev, fault_plan=plan,
                           retry_policy=RetryPolicy(sleep=False))
        got = {}
        with use_default(ctx):
            for impl in ("fused", "host"):
                y, ev, host = _timed(torch, lambda impl=impl:
                                     ring_allgather_matmul(x, w, ring,
                                                           impl=impl))
                got[impl] = {"digests": _digests(torch, coord, zip(
                    mesh.local_ranks, y)), "event_ms": ev, "host_s": host}
                del y
        return got, _logical(ctx)

    out["ring"], out["ring_logs"] = rings(FaultPlan(0, p=0.0))
    mark("rings")
    calm = snap()
    if chaos:
        plan = FaultPlan(MP_CHAOS_SEED, p=MP_CHAOS_P, kinds=("drop", "fail"))
        got, logs = rings(plan)
        out["chaos"] = {"ring": got, "ring_logs": logs,
                        "injected": len(plan.injected),
                        "by_kind": plan.injected_counts(),
                        "unrecovered": len(plan.unrecovered())}
        mark("chaos rings")
    if link:
        src = [mesh.flat(((c - 1) % RING_RANKS,)) for c, in
               map(mesh.coords, range(mesh.size))]
        tok = torch.zeros(mesh.local_size, 1, dtype=torch.float64,
                          device=dev)
        lat = []
        for _ in range(MP_LATENCY_REPS):
            _, _, s = _timed(torch, lambda: coordination.rank_gather(
                tok, mesh, src))
            lat.append(s)
        coordination.rank_gather(x, mesh, src)      # pinned buffers warm
        _, ev, s = _timed(torch, lambda: coordination.rank_gather(
            x, mesh, src))
        out["link"] = {"latency_s": lat, "stripe_bytes":
                       x[0].numel() * x.element_size(), "stripe_s": s,
                       "stripe_event_ms": ev}
        mark("link")
    del x, w
    torch.cuda.empty_cache()
    mid = snap()
    u0, up0 = _mp_fields(torch, dev)
    out["minimod"] = {}
    for mode in ("fused", "host"):
        t0 = time.perf_counter()
        r = run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS, mode=mode,
                        u0=u0, u_prev0=up0, device=dev)
        host = time.perf_counter() - t0
        mark(f"minimod {mode}")
        zmesh = make_process_mesh(shape=(NZ, 1), axes=("z", "y")) \
            if coordination.is_distributed() else RankMesh(("z", "y"),
                                                           (NZ, 1))
        out["minimod"][mode] = {
            "digests": _digests(torch, coord,
                                [(z, r.field[z * zl:(z + 1) * zl])
                                        for z in zmesh.local_ranks]),
            "event_ms": r.wall_s * 1e3, "run_host_s": host,
            "counters": json.loads(json.dumps(
                {a: getattr(r, a) for a in MINIMOD_COUNTERS}))}
        del r
        torch.cuda.empty_cache()
    del u0, up0
    torch.cuda.synchronize()
    # the calm rings' and Minimod's counts (the chaos rings' apart)
    rings_d, mm_d = since(start, calm), since(mid, snap())
    out["launches"] = {n: rings_d["launches"][n] + mm_d["launches"][n]
                       for n in names}
    out["route_launches"] = {n: {r: c + mm_d["route_launches"][n][r]
                                 for r, c in
                                 rings_d["route_launches"][n].items()}
                             for n in names}
    out["routes"] = {"ring": rings_d["routes"]["ring"],
                     "step": mm_d["routes"]["step"]}
    if chaos:
        out["chaos"]["launches"] = since(calm, mid)["launches"]
    out["transport"] = dict(coordination.TRANSPORT, sent_by_path=moved)
    return out


def mp_worker_main(argv) -> int:
    """One worker process of the multi-process phase (``--mp-worker``):
    joins the job, runs :func:`_mp_run` on the card with the kernels the
    parent built, writes its result as JSON."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--mp-worker", action="store_true")
    for flag in ("--coordinator", "--out"):
        ap.add_argument(flag, required=True)
    for flag in ("--num-processes", "--process-id", "--ranks"):
        ap.add_argument(flag, type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    import repro_torch as diomp
    from repro_torch.core import coordination
    from repro_torch.kernels import _build

    stale = [n for n in ("matmul", "ring_matmul", "wave_step",
                         "fused_wave_step") if _build._stale(n)]
    check(not stale, f"worker: kernels {stale} not built by the parent")
    diomp.init(coordinator=args.coordinator,
               num_processes=args.num_processes, process_id=args.process_id,
               local_device_count=args.ranks, device=dev)
    k = load_port()
    wrappers = {"matmul": k.matmul_kernel,
                "fused_ring_allgather_matmul":
                    k.fused_ring_allgather_matmul_kernel,
                "wave_step": k.leap,
                "fused_wave_step": k.fused_wave_step_kernel}
    two = args.num_processes == 2
    res = _mp_run(torch, dev, wrappers, link=two, chaos=two)
    tmp = Path(args.out + ".tmp")
    tmp.write_text(json.dumps(res))
    tmp.replace(args.out)
    coordination.TorchCoordinator().barrier("done")
    coordination.shutdown()
    return 0


def _mp_launch(procs: int, ranks: int) -> list:
    """Run ``procs`` worker processes of ``ranks`` ranks each on the card;
    their results, or a failure with their logs' tails (a worker that
    fails, or a launch that outlives MP_TIMEOUT_S, fails the phase at once;
    every worker is killed and reaped)."""
    import socket

    MP_DIR.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tag = f"{procs}x{ranks}"
    ps, logs, outs = [], [], []
    try:
        for pid in range(procs):
            logs.append(MP_DIR / f"{tag}.proc{pid}.log")
            outs.append(MP_DIR / f"{tag}.result{pid}.json")
            outs[-1].unlink(missing_ok=True)
            with open(logs[-1], "w") as fh:
                ps.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--mp-worker", "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", str(procs), "--process-id", str(pid),
                     "--ranks", str(ranks), "--out", str(outs[-1])],
                    cwd=str(ROOT), stdout=fh, stderr=subprocess.STDOUT))
        # until every worker exits, one fails (its peers would wait on it
        # in gloo) or the time is up
        deadline = time.monotonic() + MP_TIMEOUT_S
        while time.monotonic() < deadline and any(p.poll() is None
                                                  for p in ps):
            if any(p.poll() for p in ps):
                break
            time.sleep(0.2)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = "\n".join(f"--- {tag} proc{i} (exit {p.returncode}) ---\n"
                      + "\n".join(lg.read_text(errors="replace")
                                  .splitlines()[-25:])
                      for i, (p, lg) in enumerate(zip(ps, logs)))
    check(all(p.returncode == 0 for p in ps) and all(o.exists()
                                                     for o in outs),
          f"multi-process {tag}: a worker failed or timed out\n{tails}")
    return [json.loads(o.read_text()) for o in outs]


def multiproc_phase(torch, dev, wrappers) -> dict:
    """Rows 1-4 from several processes on the card (see MP_SPLITS): the
    1 x 4 run here, then each split's workers; every check of the phase;
    returns the launches by topology and the timings."""
    from repro_torch.core.backends import LinkModel

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = _mp_run(torch, dev, wrappers)
    runs = {"1x4": [base]}
    torch.cuda.empty_cache()
    for procs, ranks in MP_SPLITS:
        runs[f"{procs}x{ranks}"] = _mp_launch(procs, ranks)
    seconds = time.perf_counter() - t0
    rec = {"seconds": seconds, "launches": {}, "times": {}}
    for tag, rows in runs.items():
        for row in rows:
            who = f"{tag} process {row['process_id']}"
            for part in ("ring", "minimod"):
                for impl, got in row[part].items():
                    check(got["digests"] == base[part][impl]["digests"],
                          f"multi-process {who}: {part} {impl}'s bytes "
                          "differ from the 1 x 4 run's")
            for mode, got in row["minimod"].items():
                check(got["counters"] == base["minimod"][mode]["counters"],
                      f"multi-process {who}: minimod {mode}'s logs differ")
            logs = row["ring_logs"]
            check(logs["parity"] and logs["logical"]
                  == base["ring_logs"]["logical"] and logs["retries"] == 0,
                  f"multi-process {who}: the ring's gather_stats rows "
                  "differ")
            want = _mp_row_launches(row["ranks"])
            check(row["launches"] == want,
                  f"multi-process {who}: launches {row['launches']}, "
                  f"predicted {want}")
            routes = row["route_launches"]
            check(routes["matmul"]["simt"] == 0
                  and routes["fused_ring_allgather_matmul"]["simt"] == 0
                  and routes["wave_step"]["simt"] == 0
                  and routes["fused_wave_step"]["simt"] == 0,
                  f"multi-process {who}: a launch left its route: {routes}")
            whole = row["ranks"] == RING_RANKS
            check(row["routes"] == {
                "ring": {"kernel" if whole else "stepwise": 1},
                "step": {"carried" if whole else "carried_part": STEPS}},
                f"multi-process {who}: routes {row['routes']}")
            check(whole or row["transport"]["sent_bytes"] > 0,
                  f"multi-process {who}: nothing crossed the transport")
            if "chaos" in row:
                c = row["chaos"]
                check(c["injected"] > 0 and c["unrecovered"] == 0
                      and c["ring_logs"]["retries"] == c["injected"]
                      and c["ring_logs"]["logical"]
                      == base["ring_logs"]["logical"]
                      and all(c["ring"][i]["digests"]
                              == base["ring"][i]["digests"]
                              for i in ("fused", "host")),
                      f"multi-process {who}: chaos ring {c['injected']} "
                      f"faults, {c['unrecovered']} unrecovered, retries "
                      f"{c['ring_logs']['retries']}, or outputs / logs "
                      "differ from the calm run's")
        rec["launches"][tag] = [row["launches"] for row in rows]
        rec["times"][tag] = [{
            "ring": {i: [v["event_ms"], v["host_s"]]
                     for i, v in row["ring"].items()},
            "minimod_ms_per_step": {m: v["event_ms"] / STEPS
                                    for m, v in row["minimod"].items()},
            "minimod_run_host_s": {m: v["run_host_s"]
                                   for m, v in row["minimod"].items()},
            "transport": row["transport"]} for row in rows]
        for row in rows:
            log(f"multi-process {tag} process {row['process_id']}: ring "
                f"fused {row['ring']['fused']['event_ms']:.2f} ms (events), "
                f"{row['ring']['fused']['host_s']:.4f} s (host); host "
                f"{row['ring']['host']['event_ms']:.2f} ms, "
                f"{row['ring']['host']['host_s']:.4f} s; minimod fused "
                f"{row['minimod']['fused']['event_ms'] / STEPS:.3f} ms a "
                f"step (events; the run "
                f"{row['minimod']['fused']['run_host_s']:.3f} s host, "
                f"set-up and fetched field included), host "
                f"{row['minimod']['host']['event_ms'] / STEPS:.3f} ms "
                f"({row['minimod']['host']['run_host_s']:.3f} s); launches "
                f"{row['launches']}; transport "
                f"{row['transport']}")
    lk = runs["2x2"][0]["link"]
    link = LinkModel()
    rec["link"] = {**lk, "latency_min_s": min(lk["latency_s"]),
                   "stripe_GBps": lk["stripe_bytes"] / lk["stripe_s"] / 1e9,
                   "model_latency_s": link.latency_s + 8 / link.bandwidth_Bps,
                   "model_stripe_s": link.latency_s
                   + lk["stripe_bytes"] / link.bandwidth_Bps}
    rec["chaos"] = {key: runs["2x2"][0]["chaos"][key]
                    for key in ("injected", "by_kind")}
    log(f"multi-process transport (gloo, host copies via pinned memory, 2 "
        f"processes on one card): latency "
        f"{rec['link']['latency_min_s'] * 1e6:.1f} us (least of "
        f"{MP_LATENCY_REPS} 8-byte exchanges; all "
        f"{[round(s * 1e6, 1) for s in lk['latency_s']]}), one "
        f"{lk['stripe_bytes']} B stripe {lk['stripe_s']:.4f} s = "
        f"{rec['link']['stripe_GBps']:.3f} GB/s; LinkModel (NVLink): "
        f"{rec['link']['model_latency_s'] * 1e6:.4f} us and "
        f"{rec['link']['model_stripe_s'] * 1e3:.4f} ms for the same verbs")
    log(f"multi-process: 2 x 2 chaos ring {rec['chaos']} recovered, outputs "
        f"and logical logs the calm run's; phase {seconds:.1f} s")
    return rec


def main() -> int:
    if "--mp-worker" in sys.argv[1:]:
        return mp_worker_main(sys.argv[1:])
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
        for func, regs, spills in ptxas_summary(text):
            log(f"  {name}: {func}: {regs} registers, {spills}")

    k = load_port()
    wrappers = {"matmul": k.matmul_kernel,
                "fused_ring_allgather_matmul":
                    k.fused_ring_allgather_matmul_kernel,
                "wave_step": k.leap,
                "fused_wave_step": k.fused_wave_step_kernel,
                "flash_attention": k.flash_attention_kernel,
                "expert_mlp": k.expert_mlp,
                "fused_moe_dispatch": k.fused_moe_dispatch_kernel,
                "linear_scan": k.linear_scan_kernel,
                "fused_ring_attention": k.fused_ring_attention_kernel,
                "flash_attention_bwd": k.flash_attention_bwd_kernel,
                "linear_scan_bwd": k.linear_scan_bwd_kernel,
                "expert_mlp_bwd": k.expert_mlp_bwd,
                "fused_moe_dispatch_bwd": k.fused_dispatch_bwd_kernel,
                "fused_ring_attention_bwd": k.fused_ring_attention_bwd_kernel}

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

    _zero_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ring_ctx = DiompContext(mesh=RankMesh(("ring",), (n,)), device=dev)
    ring = DiompGroup(("ring",), name="ring")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with use_default(ring_ctx):
        marks[0].record()
        y_fused = ring_allgather_matmul(x, w, ring, impl="fused")
        marks[1].record()
        y_host = ring_allgather_matmul(x, w, ring, impl="host")
        marks[2].record()
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    # Fig. 7's fused-versus-host comparison on the card (CUDA events; the
    # first calls, so each includes its ring's one-time costs)
    log(f"ring at N = {N}: fused {marks[0].elapsed_time(marks[1]):.2f} ms, "
        f"host {marks[1].elapsed_time(marks[2]):.2f} ms (CUDA events)")
    # Minimod's initial fields: random, so every rank boundary, both
    # Dirichlet edges and the ring's zeroed wrap carry data from step one
    u0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    up0 = torch.randn((GRID,) * 3, generator=g, device=dev) * 0.1
    # the fused step's stacked (nz, 1, Z, Y, X) fields: views of the same grid
    u1, up1 = (a.view(NZ, 1, zl, GRID, GRID) for a in (u0, up0))
    # each mode's stencil launches, read around its run
    mm, mm_launches = {}, {}
    for mode in ("fused", "host"):
        before = _stencil_counts(k)
        mm[mode] = run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS,
                               mode=mode, u0=u0, u_prev0=up0, device=dev)
        mm_launches[mode] = _stencil_delta(before, _stencil_counts(k))
    step_ctx = DiompContext(mesh=RankMesh(("z", "y"), (NZ, 1)), device=dev)
    with use_default(step_ctx):
        y_step = st_fused.fused_wave_step(u1, up1, 0.1,
                                          DiompGroup(("z",), name="z"))
    torch.cuda.synchronize()
    launches = {name: wr.launches for name, wr in wrappers.items()
                if name in ("matmul", "fused_ring_allgather_matmul",
                            "wave_step", "fused_wave_step")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path: launches {launches}; ring {ring_s:.2f} s (fused+host); "
        f"minimod fused {mm['fused'].wall_s:.3f} s, host "
        f"{mm['host'].wall_s:.3f} s; peak {peak_gb:.1f} GB")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    # every GEMM of the ring at N = 30240 (bf16, K and n_loc multiples of
    # 8) takes the tensor-core route, and every leap of Minimod (f32,
    # 4128-byte rows) the TMA ring
    routes = {name: dict(wrappers[name].route_launches)
              for name in ("matmul", "fused_ring_allgather_matmul",
                           "wave_step", "fused_wave_step")}
    log(f"main path: GEMM and stencil routes {routes}")
    for name in ("matmul", "fused_ring_allgather_matmul"):
        taken = routes[name]
        check(taken["simt"] == 0 and taken["wgmma"] == launches[name],
              f"{name}: a main-path launch left the tensor cores: {taken}")
    check(routes["wave_step"]["simt"] == 0
          and routes["wave_step"]["tma"] == launches["wave_step"],
          f"wave_step: a Minimod launch left the TMA route: "
          f"{routes['wave_step']}")
    # fused mode: every step one carried launch of the fused kernel on the
    # TMA ring, no leap; host mode: every step one leap, no fused kernel
    log(f"main path: Minimod stencil launches by mode {mm_launches}")
    fused_d, host_d = mm_launches["fused"], mm_launches["host"]
    check(fused_d["fused_wave_step"] == (STEPS, {"simt": 0, "tma": STEPS})
          and fused_d["wave_step"][0] == 0,
          f"fused Minimod: not {STEPS} fused launches on tma and no leap: "
          f"{fused_d}")
    check(host_d["wave_step"][0] == STEPS
          and host_d["fused_wave_step"][0] == 0,
          f"host Minimod: not one leap a step: {host_d}")
    check(launches["fused_wave_step"] == STEPS + 1
          and routes["fused_wave_step"]["tma"] == STEPS + 1,
          f"fused_wave_step: {launches['fused_wave_step']} launches, "
          f"routes {routes['fused_wave_step']}")

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
    # the counters against the emulation's on shape-only (meta) tensors:
    # the CPU path's records, without its arithmetic
    emu = run_minimod(grid=(GRID,) * 3, nz=NZ, steps=STEPS, mode="fused",
                      device="meta")
    for attr in MINIMOD_COUNTERS:
        check(getattr(mm["fused"], attr) == getattr(emu, attr),
              f"fused Minimod: {attr} {getattr(mm['fused'], attr)} vs the "
              f"emulation's {getattr(emu, attr)}")
    del emu
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

    # -- the main path's kernels under chaos (rows 1-4) ------------------------
    t0 = time.perf_counter()
    chaos_main_path(torch, k, dev, wrappers, x, w, u0, up0)
    log(f"chaos: main path's rows in {time.perf_counter() - t0:.1f} s")

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
        if name in routes:
            kernels[-1]["route_launches"] = routes[name]
        log(f"{name}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
            f"{library_ms}, bound {b_ms:.3f} ms by {b_by}), err {err:.4g}")

    # local GEMM of one rank: (t_loc x N) @ (N x n_loc)
    from repro_torch.kernels.plan import OverlapPlanner
    plan = OverlapPlanner().plan_ring_matmul(t_loc, N, n_loc, torch.bfloat16,
                                             n)
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
    kernels[-1]["device_ms"] = device_ms(
        torch, lambda: k.matmul_kernel(a, b), 3, MATMUL_KERNELS)
    log(f"matmul at the ring's ({t_loc} x {N}) @ ({N} x {n_loc}) bf16: "
        f"device {_ms(kernels[-1]['device_ms'], 4)} ms")
    del a, b

    got = k.fused_ring_allgather_matmul_kernel(x, w, plan=plan)
    want = k.ring_allgather_matmul_plain(x, w)
    err = max_err(torch, got, want)
    del got, want
    xf = x.reshape(n * t_loc, N)
    # the card's clock and power over the fused ring's timing (~0.5 s)
    with CardSampler() as sampled:
        ring_ms = cuda_ms(torch, lambda: k.fused_ring_allgather_matmul_kernel(
            x, w, plan=plan), 3)
    log(f"card under the fused ring's timing: {sampled.summary()}")
    entry("fused_ring_allgather_matmul", "src/repro_torch/csrc/ring_matmul.cu",
          "src/repro/kernels/ring_matmul/fused.py:155", err, ring_ms,
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
    # the card's own time in the kernel (warm), beside the event time, and
    # where the difference goes
    kernels[-1]["device_ms"] = device_ms(
        torch, lambda: k.leap(uext, prev, 0.1), 5, LEAP_KERNELS)
    gap = host_and_events(torch, lambda: k.leap(uext, prev, 0.1), 5)
    kernels[-1]["event_gap"] = gap
    log(f"wave_step at 1024^3: host {gap['host_ms']:.4f} ms a call, events "
        f"{gap['event_ms']:.4f}, device {_ms(kernels[-1]['device_ms'], 4)}")
    del uext, prev
    torch.cuda.empty_cache()
    # Minimod host mode's step: the (4, 1, 256, 1024, 1024) stacked field
    # padded, the neighbours' halo slabs written in (paper Listing 1), one
    # batched launch
    uext = torch.nn.functional.pad(u1, (R,) * 6)
    uext[1:, :, 0:R, R:-R, R:-R] = u1[:-1, :, zl - R:]
    uext[:-1, :, -R:, R:-R, R:-R] = u1[1:, :, :R]
    got = k.leap(uext, up1, 0.1)
    want = k.leap_plain(uext, up1, 0.1)
    h_err = max_err(torch, got, want)
    check(h_err <= 2e-5 * float(want.abs().max()), "leap at host mode's shape")
    del got, want
    torch.cuda.empty_cache()
    h_ms = cuda_ms(torch, lambda: k.leap(uext, up1, 0.1), 5)
    h_dev = device_ms(torch, lambda: k.leap(uext, up1, 0.1), 5, LEAP_KERNELS)
    h_gap = host_and_events(torch, lambda: k.leap(uext, up1, 0.1), 5)
    h_bound, h_by = bound(4 * (uext.numel() + 2 * pts),
                          STENCIL_OPS_PER_POINT * pts, "float32")
    kernels[-1]["minimod_host_shape"] = {
        "shape": [NZ, 1, zl, GRID, GRID], "max_abs_err": h_err, "ms": h_ms,
        "device_ms": h_dev, "bound_ms": h_bound, "bound_by": h_by,
        "event_gap": h_gap}
    log(f"wave_step at Minimod host mode's {NZ} x {zl} x {GRID}^2: "
        f"{h_ms:.3f} ms (device {_ms(h_dev, 3)}), bound {h_bound:.3f} ms by "
        f"{h_by}, err {h_err:.4g}; at 1024^3 device "
        f"{_ms(kernels[-1]['device_ms'], 3)} ms")
    del uext
    torch.cuda.empty_cache()

    # the fused step at Minimod's (4, 1, 256, 1024, 1024): the single step
    # ("ms") and the time loop's carried step ("carried"), each against its
    # plain version; bytes: u and prev read, out written, and 2 x 2R planes
    # a rank into and out of the windows or halos
    splan = OverlapPlanner().plan_halo_slots(zl, GRID, GRID, torch.float32, NZ)
    kern = k.fused_wave_step_kernel

    def single():
        return kern(u1, up1, 0.1, plan=splan)

    err = max_err(torch, single(), k.fused_step_plain(u1, up1, 0.1, dx=1.0))
    with use_default(step_ctx):
        h1 = st_fused.exchange_halos(u1, DiompGroup(("z",), name="z"))

    def carried():
        return kern(u1, up1, 0.1, plan=splan, halos=h1, return_halos=True)

    def carried_plain():
        return k.fused_step_carried_plain(u1, up1, 0.1, h1, dx=1.0)

    got, want = carried(), carried_plain()
    c_err = max(max_err(torch, got[0], want[0]),
                max_err(torch, got[1].z_lo, want[1].z_lo),
                max_err(torch, got[1].z_hi, want[1].z_hi))
    c_scale = float(want[0].abs().max())
    check(c_err <= 2e-5 * c_scale, f"carried fused step: err {c_err}")
    del got, want
    torch.cuda.empty_cache()
    f_bytes = 4 * 3 * pts + 4 * 2 * 2 * R * NZ * GRID * GRID
    entry("fused_wave_step", "src/repro_torch/csrc/fused_wave_step.cu",
          "src/repro/kernels/stencil/fused.py:461", err,
          cuda_ms(torch, single, 5),
          cuda_ms(torch, lambda: k.fused_step_plain(
              u1, up1, 0.1, dx=1.0), 2),
          f_bytes, STENCIL_OPS_PER_POINT * pts, "float32", None)
    row = kernels[-1]
    row["device_ms"] = device_ms(torch, single, 5, FUSED_KERNELS)
    row["event_gap"] = host_and_events(torch, single, 5)
    row["carried"] = {
        "max_abs_err": c_err, "ms": cuda_ms(torch, carried, 5),
        "device_ms": device_ms(torch, carried, 5, FUSED_KERNELS),
        "plain_ms": cuda_ms(torch, carried_plain, 2),
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "event_gap": host_and_events(torch, carried, 5)}
    log(f"fused_wave_step: single {row['ms']:.4f} ms (device "
        f"{_ms(row['device_ms'], 4)}), carried {row['carried']['ms']:.4f} "
        f"(device {_ms(row['carried']['device_ms'], 4)}, plain "
        f"{row['carried']['plain_ms']:.3f}, err {c_err:.4g}); event gaps "
        f"{row['event_gap']} / {row['carried']['event_gap']}")
    del h1
    torch.cuda.empty_cache()

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
    del u0, up0, u1, up1
    torch.cuda.empty_cache()

    # -- phase 7: serving glm4-9b at full width ---------------------------------
    flash = serve_phase(torch, k, dev, wrappers)
    kernels.append(flash)

    # -- phase 8: serving qwen3-moe at full width, the dropless ring ----------
    mlp_line, dispatch = moe_phase(torch, k, dev, wrappers)
    kernels.extend([mlp_line, dispatch])

    # -- phase 8b: serving qwen3-moe under expert2d, row 7 on 4 ranks -------
    e2d_serve = moe_expert2d_serve_phase(torch, k, dev, wrappers)
    mlp_line["expert2d_serve"] = e2d_serve
    mlp_line.setdefault("launches_by_path", {})["serve qwen3-moe expert2d"] \
        = e2d_serve["expert2d"]["expert_mlp"] \
        + e2d_serve["expert2d_2slots"]["expert_mlp"]

    # -- phase 9: serving deepseek-v3 (MLA) at full width, flash at D = 192 --
    mla = mla_phase(torch, k, dev, wrappers)
    flash["mla_chunk"] = mla["flash_chunk"]
    dispatch["mla_decode"] = mla["dispatch_decode"]
    dispatch["mla_chunk"] = mla["dispatch_chunk"]
    mlp_line["mla_chunk"] = mla["mlp_chunk"]     # row 7 at deepseek's blocks
    dispatch["launches_by_path"] = {"qwen3-moe": dispatch["launches"],
                                    "deepseek-v3": mla["dispatch_launches"]}
    dispatch["launches"] += mla["dispatch_launches"]
    for route, n in mla["dispatch_routes"].items():
        dispatch["route_launches"][route] += n

    # -- phase 10: qwen1.5-110b and command-r-plus-104b, flash at G = 8, 12 --
    by_path = flash.setdefault("launches_by_path", {})
    by_path["deepseek-v3"] = mla["flash_launches"]
    for arch in GQA_ARCHS:
        gqa = gqa_phase(torch, k, dev, wrappers, arch)
        by_path[arch] = gqa.pop("launches")
        flash[f"{arch}_chunk"] = gqa

    # -- phases 11-12: rwkv6-7b and zamba2-1.2b, the recurrent scan ---------
    rec = {arch: recurrent_phase(torch, k, dev, wrappers, arch)
           for arch in REC_ARCHS}
    scan = {"name": "linear_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/linear_scan.cu",
            "replaces": "src/repro/kernels/linear_scan/kernel.py:104",
            "launches": sum(r["launches"] for r in rec.values()),
            "shape": "rwkv6 prefill"}
    scan.update(rec["rwkv6-7b"]["prefill"])
    scan["rwkv6_decode"] = rec["rwkv6-7b"]["decode"]
    scan["zamba2_prefill"] = rec["zamba2-1-2b"]["prefill"]
    scan["zamba2_decode"] = rec["zamba2-1-2b"]["decode"]
    scan["launches_by_phase"] = {a: r["launches"] for a, r in rec.items()}
    scan["route_launches"] = {route: sum(r["routes"][route]
                                         for r in rec.values())
                              for route in ("prefill", "decode")}
    for r in rec.values():
        flash.update(r["flash"])
    check(all(r["launches"] > 0 for r in rec.values()),
          "linear_scan: a recurrent phase launched no scan")
    kernels.append(scan)

    # -- phase 13: paligemma-3b under seq_parallel="ring", the ring kernel ---
    ring = ring_phase(torch, k, dev, wrappers)
    flash.update(ring.pop("flash"))
    ring["mla_chunk"] = mla["ring_chunk"]
    check(ring["launches"] > 0, "ring attention: the phase launched no ring")
    kernels.append(ring)

    # -- phase 13b: paligemma-3b's attention block trained under "ring" ----
    ring_bwd = ring_attention_train_phase(torch, k, dev, wrappers)
    ring["launches_by_path"] = {"serve paligemma-3b": ring["launches"],
                                "train paligemma-3b block":
                                    ring_bwd.pop("row9")["launches"]}
    ring["launches"] += ring["launches_by_path"]["train paligemma-3b block"]
    ring["seq_parallel"]["with_lse"] = ring_bwd.pop("row9_forward")
    check(ring_bwd["launches"] > 0, "ring attention's gradient: the phase "
          "launched no row 14")
    kernels.append(ring_bwd)

    # -- phase 14: the unified runtime and the hierarchical backend -----------
    rt = runtime_phase(torch, dev)
    log("runtime: " + json.dumps(rt))

    # -- phase 15: the paper's examples (quickstart, Cannon, Minimod) ---------
    ex = examples_phase(torch, k, dev, wrappers, kernels)
    log("examples: " + json.dumps(ex))

    # -- phase 16: training stablelm-3b, flash attention's gradient -----------
    bwd = train_phase(torch, k, dev, wrappers)
    flash.setdefault("launches_by_path", {})["train"] = \
        bwd["train"]["flash_forward"]["forward"]
    flash["train"] = bwd.pop("forward")     # row 5's training entry
    kernels.append(bwd)

    # -- phase 16b: stablelm-3b under chaos, and the elastic restore -------
    t0 = time.perf_counter()
    train_chaos_phase(torch, k, dev, wrappers)
    log(f"chaos: training runs in {time.perf_counter() - t0:.1f} s")

    # -- phase 17: the long-context decode, zamba2-1.2b at 524,288 tokens ----
    long = long_decode_phase(torch, k, dev, wrappers)
    by_path["long_decode"] = long["launches"]
    flash["long_decode_cp_partial"] = long.pop("cp_partial")
    scan["launches_by_phase"]["long_decode"] = long["scan_launches"]
    log("long: " + json.dumps(long))

    # -- phase 18: the audio family, hubert-xlarge's encoder and training ----
    audio = audio_phase(torch, k, dev, wrappers)
    by_path["hubert_forward"] = audio["forward"]["launches"]
    for layout, run in audio["train"].items():
        by_path[f"hubert_train_{layout}"] = run["flash"]["forward"]
    flash["hubert_encoder"] = audio.pop("flash_forward")
    hub = audio.pop("bwd")
    flash["hubert_train"] = hub.pop("forward")
    hub["train"] = audio
    bwd["hubert"] = hub
    bwd["launches_by_path"] = {
        "stablelm-3b": bwd["launches"],
        **{f"hubert-xlarge {layout}": run["flash"]["backward"]
           for layout, run in audio["train"].items()}}

    # -- phase 19: training the recurrent families, the scan's backward -----
    rec_train = {arch: recurrent_train_phase(torch, k, dev, wrappers, arch)
                 for arch in REC_TRAIN_LAYERS}
    for arch, run in rec_train.items():
        scan["launches_by_phase"][f"train {arch}"] = \
            run["launches"]["linear_scan"]
        if run["launches"]["flash_attention"]:
            by_path[f"train {arch}"] = run["launches"]["flash_attention"]
            bwd["launches_by_path"][arch] = \
                run["launches"]["flash_attention_bwd"]
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(5)
    scan_bwd = {"name": "linear_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/linear_scan_bwd.cu",
                "replaces": "src/repro/kernels/linear_scan/kernel.py:104 "
                            "(the gradient of its forward; the reference "
                            "differentiates linear_scan_ref, "
                            "src/repro/kernels/linear_scan/ref.py:23)",
                "launches": sum(r["launches"]["linear_scan_bwd"]
                                for r in rec_train.values()),
                "route_launches": {"chunked": sum(
                    r["routes"]["linear_scan_bwd"]["chunked"]
                    for r in rec_train.values())},
                "launches_by_path": {a: r["launches"]["linear_scan_bwd"]
                                     for a, r in rec_train.items()}}
    # a layer's call of the training path: 2 x 2 ranks, a microbatch of 2
    # sequences, 32 heads a rank (both models), M = N = 64; rwkv6's readout
    # timed, zamba2's checked
    BH = 4 * (TRAIN_BATCH // 2 // TRAIN_MICRO) * 32
    scan_bwd.update(_scan_bwd_at(torch, k, g, BH, True))
    scan_bwd["post_readout"] = _scan_bwd_at(torch, k, g, BH, False)
    scan_bwd["train"] = rec_train
    kernels.append(scan_bwd)
    torch.cuda.empty_cache()

    # -- phase 20: the weight ring of the ZeRO-3 gather ----------------------
    ring_fsdp = ring_train_phase(torch, k, dev)
    log("ring_fsdp: " + json.dumps(ring_fsdp))

    # -- phase 21: training qwen3-moe, rows 12 and 13; expert2d ------------
    row12, row13, row7_e2d = moe_train_phase(torch, k, dev, wrappers)
    kernels.extend([row12, row13])
    mlp_line["expert2d_train"] = row7_e2d       # row 7 at E_loc 32, 4 sources
    mlp_line.setdefault("launches_by_path", {}).update({
        "train qwen3-moe": row12["train"]["launches"]["expert_mlp"],
        "train qwen3-moe expert2d": row7_e2d["launches"]})

    # -- phase 22: training deepseek-v3, its MTP term, row 10 at D = 192 ----
    ds = deepseek_train_phase(torch, k, dev, wrappers)
    a2a, fused_run = ds["runs"]["a2a"], ds["runs"]["fused"]
    by_path["train deepseek-v3"] = (a2a["launches"]["flash_attention"]
                                    + fused_run["launches"]["flash_attention"])
    flash["deepseek_train"] = ds["row10"].pop("forward")
    bwd["launches_by_path"]["deepseek-v3"] = (
        a2a["launches"]["flash_attention_bwd"]
        + fused_run["launches"]["flash_attention_bwd"])
    bwd["deepseek_train"] = {**ds["row10"], "train": ds["runs"],
                             "phase_s": ds["seconds"]}
    e2d = ds["runs"]["expert2d"]
    by_path["train deepseek-v3"] += e2d["launches"]["flash_attention"]
    bwd["launches_by_path"]["deepseek-v3"] += \
        e2d["launches"]["flash_attention_bwd"]
    mlp_line["launches_by_path"].update({
        "train deepseek-v3": a2a["launches"]["expert_mlp"],
        "train deepseek-v3 expert2d": e2d["launches"]["expert_mlp"]})
    dispatch["launches_by_path"]["train deepseek-v3"] = \
        fused_run["launches"]["fused_moe_dispatch"]
    for row, impl, name in ((row12, "a2a", "expert_mlp_bwd"),
                            (row13, "fused", "fused_moe_dispatch_bwd")):
        row["launches_by_path"] = {
            "qwen3-moe": row["launches"],
            "deepseek-v3": ds["runs"][impl]["launches"][name]}
        row["deepseek_train"] = {
            **ds["row12" if impl == "a2a" else "row13"],
            "checks": {"layers": ds["checks"]["layers"],
                       **ds["checks"][impl]}}
    row12["launches_by_path"].update({
        "qwen3-moe expert2d": row12["expert2d"]["launches"],
        "deepseek-v3 expert2d": e2d["launches"]["expert_mlp_bwd"]})
    row12["expert2d"]["deepseek_checks"] = {
        "layers": ds["checks"]["layers"], **ds["checks"]["expert2d"]}
    # -- phase 23: rows 1-4 from 2 and 4 processes on the card ---------------
    mp = multiproc_phase(torch, dev, wrappers)
    log("multiprocess: " + json.dumps(mp))
    for row in kernels:
        if row["name"] in MP_ROWS:
            per = {tag: [c[row["name"]] for c in counts]
                   for tag, counts in mp["launches"].items()}
            row.setdefault("launches_by_path", {})["multiprocess"] = sum(
                sum(v) for v in per.values())
            row["multiprocess"] = {"launches_by_process": per,
                                   "times": mp["times"]}
    check(len(kernels) == len(wrappers) == 14, "kernels line incomplete")
    # the chaos phase's launches, by kernel: every row it drives launched
    by_name = {row["name"]: row for row in kernels}
    for name in ("matmul", "fused_ring_allgather_matmul", "wave_step",
                 "fused_wave_step", "flash_attention", "fused_moe_dispatch",
                 "fused_ring_attention", "flash_attention_bwd"):
        check(CHAOS_LAUNCHES.get(name, 0) > 0,
              f"chaos: {name} was not launched in the chaos phase")
    for name, n in CHAOS_LAUNCHES.items():
        by_name[name].setdefault("launches_by_path", {})["chaos"] = n
    log("chaos: " + json.dumps(CHAOS))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
