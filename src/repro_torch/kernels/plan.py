"""OverlapPlanner — the §3.2 bounded-concurrency contract made concrete.

``StreamPool.plan_slots`` answers ONE question ("how many staging buffers
may a kernel keep in flight for a given working set?"); this module turns
that answer into the concrete slot/tile plans the CUDA kernels and their
emulations execute:

* :class:`RingPlan` — the schedule of the fused collective matmul: stripe
  slots per ring direction, which stripe each step computes, which buffers
  each step forwards.  The bidirectional ring covers the ``n - 1`` remote
  stripes in ``ceil((n - 1) / 2)`` exchange steps.
* :class:`AttentionRingPlan` — the same ring rotating K/V stripes for
  sequence-parallel attention, with causal step skipping and the put books.
* :class:`HaloPlan` — the phase order of the fused Minimod step.
* :class:`AllToAllPlan` — the put ring of the dropless MoE dispatch, with
  per-expert asymmetric landing capacities.
* matmul tile / stencil chunk planning against what the port's own kernels
  stage (see ``SMEM_BUDGET_DEFAULT``).

Everything is derived from static shapes, deterministic and cheap.  Schedules
equal the reference's record for record; budgets and tiles are the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.streams import MAX_ACTIVE_STREAMS_DEFAULT, StreamPool

__all__ = [
    "AllToAllPlan",
    "AttentionRingPlan",
    "RingStep",
    "RingPlan",
    "HaloPlan",
    "OverlapPlanner",
    "default_planner",
    "gemm_route",
    "attention_route",
    "attention_bwd_route",
    "attention_bwd_w256_smem_bytes",
    "attention_bwd_wide_smem_bytes",
    "expert_route",
    "expert_bwd_route",
    "expert_bwd_tiles",
    "expert_bwd_work_words",
    "expert_bwd_scratch_elems",
    "expert_bwd_smem_bytes",
    "stencil_route",
    "scan_route",
    "scan_instance",
    "scan_smem_bytes",
    "expert_tile_n",
    "expert_live_tiles",
    "expert_list_len",
    "expert_items",
    "plan_key_splits",
    "key_split_tiles",
    "resolve_ring_impl",
    "resolve_dispatch_impl",
    "resolve_seq_parallel",
    "split_extents",
    "SMEM_BUDGET_DEFAULT",
    "MM_TILE",
    "TC_TILE",
    "TC_STAGES",
    "STENCIL_TILE",
    "STENCIL_TMA_TILE",
    "STENCIL_STAGES",
    "STENCIL_ROUTES",
    "SCAN_SUB",
    "SCAN_CHUNK",
    "SCAN_THREADS",
    "SCAN_ROUTES",
    "FLASH_BQ",
    "ATT_TC_BK",
    "ATT_TC_STAGES",
    "ATT_TC_THREADS",
    "EX_TC_TILE",
    "EX_TC_BR",
    "EX_TC_NS",
    "EX_TC_STAGES",
    "EX_TC_THREADS",
    "EXB_BR",
    "EXB_STAGES",
    "EXB_BOXES",
    "EXB_SLOTS",
    "EXB_OUT_TILES",
    "EXB_THREADS",
    "SMS_DEFAULT",
]

# Shared memory one block may use on an H100: 232,448 bytes (227 KB) of the
# SM's 256 KB (hopper-kernels guide, section 1).  The planner sizes every
# stage against what the port's CUDA kernels put there, not the reference's
# 16 MiB TPU VMEM budget:
#
# * matmul and the fused ring's GEMMs take one of two routes
#   (:func:`gemm_route`).  On the tensor cores they keep ``TC_STAGES``
#   stages of one (BM, BK) tile of X and one (BK, BN) tile of W per block,
#   in the operands' 16-bit type — ``TC_TILE``, 4·(128·64 + 64·256)·2 B =
#   192 KiB; on the CUDA cores ``MM_STAGES`` cp.async stages of the same
#   pair in f32, A's k-major with ``MM_APAD`` floats of padding a k row —
#   ``MM_TILE``, 3·(16·132 + 16·128)·4 B = 48.75 KiB (``mm_smem_bytes``,
#   the formula of csrc/matmul.cuh's ``mm_smem_bytes``), two blocks an SM;
# * the wave step (``leap``) takes one of two routes (:func:`stencil_route`).
#   On the TMA route a block keeps a ring of ``STENCIL_STAGES`` f32 plane
#   tiles of (LEAP_TY + 2R, LEAP_TX + 2R) and their mbarriers —
#   ``STENCIL_TMA_TILE``, 8·(32 + 8)·(64 + 8)·4 B = 90 KiB at R = 4, plus
#   alignment slack and barriers (``stencil_stage_bytes``, the formula of
#   csrc/wave_step.cu's ``leap_tma_smem_bytes``), so two blocks an SM fit;
#   on the CUDA cores it stages one (TY + 2R, TX + 2R) plane tile —
#   ``STENCIL_TILE``, (8 + 8)·(32 + 8)·4 B = 2.5 KiB.  Both carry the Z
#   neighbours in registers, so the stage does not grow with the Z chunk a
#   block walks;
# * the linear scan's prefill route stages a chunk of p, q, a and r and
#   keeps the chunk's weights and the state in shared memory
#   (``scan_smem_bytes``, the formula of csrc/linear_scan.cu's
#   ``scan_smem_bytes``); its decode route stages nothing;
# * flash and ring attention take one of two routes
#   (:func:`attention_route`).  On the tensor cores a block keeps the
#   FLASH_BQ-row q tile and ``ATT_TC_STAGES`` stages of a 64-key k and v
#   tile in the operands' 16-bit type (``attention_tc_stage_bytes``, the
#   formula of csrc/attention.cuh's ``att_tc_smem_bytes``, whole
#   64-column boxes: D = 80 stages two, MLA's D = 192 three): 105 KiB at
#   D = 192, Dv = 128, 161 KiB at D = Dv = 256.  On the
#   CUDA cores it stages, per block, the scaled q^T of a
#   FLASH_BQ-row tile and, per key tile of ``block`` keys, k^T, v and the
#   probabilities, all in f32 with one column of padding against bank
#   conflicts (``OverlapPlanner.flash_stage_bytes``, the formula of
#   ``launch()`` in csrc/flash_attention.cu): 113 KiB at D = Dv = 128 and
#   block = 64, staged once (no double buffer);
# * the expert MLP and the fused MoE dispatch's GEMMs take one of two
#   routes (:func:`expert_route`).  On the tensor cores a block keeps
#   ``EX_TC_STAGES`` stages of one (64 K, 64 columns) tile of each weight a
#   pass reads (w_gate and w_up, or w_down) and a row tile of up to
#   ``EX_TC_BR`` rows of 64 K columns, in the operands' 16-bit type
#   (``expert_tc_smem_bytes``, the formula of csrc/expert_mlp.cuh's
#   ``ex_tc_smem_bytes``): 193 KiB for the gate/up pass's stages.  On the
#   CUDA cores it stages one (BK, BM) tile of x and a (BK, BN) tile of each
#   of w_gate and w_up per block, in f32 — (32·68 + 2·32·64)·4 B = 24.5 KiB
#   at the fixed tile of csrc/expert_mlp.cuh, nothing the planner sizes;
# * their gradients (csrc/expert_bwd.cuh) take the same rule
#   (:func:`expert_bwd_route`).  On the tensor cores a block keeps the dW
#   pass's ``EXB_STAGES`` stages of three 64 x 64 boxes, its ``EXB_SLOTS``
#   slots of four (x and dy of ``EXB_BR`` packed rows) and its
#   ``EXB_OUT_TILES`` output tiles, over which the other passes lay their
#   stages of up to ``EXB_BOXES`` boxes (weight tiles and packed tiles), in
#   the operands' 16-bit type, and the barriers of each stage and slot
#   (:func:`expert_bwd_smem_bytes`, the formula of ``exb_smem_bytes``): 217
#   KiB.  On the CUDA cores five (32, 68) f32 tiles, 42.5 KiB;
# * the fused ring's stripe slots, the fused step's landing windows, the
#   fused MoE dispatch's landing and return slots and the ring attention's
#   K/V stripe slots and (m, l, acc) carry live in device memory, not shared
#   memory.
#
# At 1024³ over nz = 4 the halo stage is the TMA route's 90 KiB ring, two of
# which fit the budget, and the overlapped schedule stands.  The reference's
# staging formula with 227 KB as its budget would stage (1+8)(8+8)(1032)·4 B
# ≈ 594 KB and fall back to the serialized one.
SMEM_BUDGET_DEFAULT = 232_448
MM_TILE = (128, 16, 128)        # (BM, BK, BN) of csrc/matmul.cuh mm_tile
MM_STAGES = 3                   # that tile's cp.async ring of f32 stages
MM_APAD = 4                     # f32 of padding after each k row of A's stage
TC_TILE = (128, 64, 256)        # (BM, BK, BN) of its tensor-core route
TC_STAGES = 4                   # that route's shared-memory stages
STENCIL_TILE = (8, 32)          # (TY, TX) of csrc/wave_step.cu, CUDA cores
STENCIL_TMA_TILE = (32, 64)     # (LEAP_TY, LEAP_TX) of its TMA route
STENCIL_STAGES = 8              # that route's ring of plane tiles
STENCIL_ROUTES = ("simt", "tma")  # route codes of csrc/wave_step.cu
SCAN_SUB = 16                   # rows of a sub-chunk in csrc/linear_scan.cu
SCAN_CHUNK = 32                 # rows of a chunk on the served path
SCAN_THREADS = 256              # threads of its prefill block
SCAN_ROUTES = ("prefill", "decode")  # route codes of csrc/linear_scan.cu
FLASH_BQ = 64                   # query rows of a csrc/flash_attention.cu tile
FLASH_BLOCKS = (64, 32, 16)     # the key tiles that kernel takes
FLASH_MAX_DV = 256              # the widest value head it takes
ATT_TC_BK = 64                  # keys a tile on attention's tensor-core route
ATT_TC_STAGES = 2               # that route's k / v stages
ATT_TC_THREADS = 160            # a consumer warpgroup and a producer warp
BWD_TC_STAGES = 2               # the gradient's tensor-core ring of stages
BWD_TC_THREADS = 160            # a consumer warpgroup and a producer warp
BWD_WIDE_THREADS = 288          # its D = 192 dk/dv pass: 2 warpgroups
BWD_W_THREADS = 512             # its D = Dv = 256 passes: 4 warpgroups
EX_TC_TILE = (64, 64)           # (weight columns, K) of an expert-MLP item
EX_TC_BR = 128                  # rows of its row tile, at most
EX_TC_NS = (8, 16, 32, 64, 128)  # the row tile's instances (wgmma's N)
EX_TC_STAGES = 6                # that route's shared-memory stages
EX_TC_THREADS = 160             # a consumer warpgroup and a producer warp
EXB_BR = 64                     # rows of an expert-MLP gradient packed tile
EXB_STAGES = 3                  # that route's shared-memory stages
EXB_BOXES = 8                   # 64 x 64 boxes a stage holds at most (pass A)
EXB_SLOTS = 3                   # its dW pass's x and dy slots, a tile each
EXB_OUT_TILES = 6               # its dW pass's 64 x 64 output tiles
EXB_THREADS = 288               # two consumer warpgroups and a producer warp
SMS_DEFAULT = 132               # streaming multiprocessors of an H100 SXM


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def gemm_route(dtype, k: int, n: int, *ptrs: int) -> str:
    """The route a GEMM launch of ``(.., K) @ (K, N)`` takes in
    ``csrc/matmul.cu`` and ``csrc/ring_matmul.cu``: ``"wgmma"`` (TMA and
    the tensor cores) for 16-bit operands whose row pitches K and N are
    multiples of 8 elements and whose base pointers (``ptrs``) are 16-byte
    aligned, TMA's rule; ``"simt"`` (the CUDA cores) otherwise.  f32 stays
    on the CUDA cores: TF32 would change its results."""
    if dtype in (torch.float16, torch.bfloat16) and k % 8 == 0 \
            and n % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


def attention_route(dtype, d: int, dv: int, g: int, *ptrs_and_strides: int
                    ) -> str:
    """The route a flash- or ring-attention launch takes in
    ``csrc/attention.cuh``: ``"wgmma"`` (TMA and the tensor cores) for
    16-bit operands whose query/key head dim D is a multiple of 16 in [16,
    256] (a runtime value: whole 64-column boxes, so deepseek-v3's MLA
    D = 192 is three), whose value head dim Dv is a multiple of 16 in [16,
    128], or 256 (the widths of the kernels' instances; every served and
    trained shape, stablelm-3b's 80 included), whose G = H / KH query heads
    a kv head divides the 64-row tile, and whose base pointers and byte
    strides (``ptrs_and_strides``: those TMA reads, the strides of dims
    longer than 1) are 16-byte aligned; ``"simt"`` (the CUDA cores)
    otherwise.  f32 stays on the CUDA cores: TF32 would change its
    results."""
    if dtype in (torch.float16, torch.bfloat16) \
            and 16 <= d <= 256 and d % 16 == 0 \
            and ((16 <= dv <= 128 and dv % 16 == 0) or dv == 256) \
            and g >= 1 and 64 % g == 0 \
            and all(x % 16 == 0 for x in ptrs_and_strides):
        return "wgmma"
    return "simt"


def attention_bwd_route(dtype, d: int, dv: int, g: int,
                        *ptrs_and_strides: int) -> str:
    """The route a flash-attention gradient launch takes in
    ``csrc/flash_attention_bwd.cu``: ``"wgmma"`` (TMA and the tensor cores)
    for 16-bit operands whose head dim D is a multiple of 16 in [16, 128]
    or 192 (deepseek-v3's MLA: the wide instance, its dk/dv pass split
    over two warpgroups) and whose Dv is a multiple of 16 in [16, 128], or
    with D = Dv = 256,
    whose G = H / KH query heads a kv head divides the 64-row tile, and
    whose base pointers and byte strides (``ptrs_and_strides``: those TMA
    and the bulk copies read) are 16-byte aligned; ``"simt"`` (the CUDA
    cores) otherwise.  f32 stays on the CUDA cores (TF32 would change its
    results).  D = Dv = 256 (paligemma-3b's heads) takes the tensor cores
    too, on the 256-wide instance (four consumer warpgroups, each holding
    a 128-column slice of a 64-key tile's dk or dv); D or Dv of 256 with
    the other width off 256 stays on the CUDA cores."""
    def width_ok(x):
        return 16 <= x <= 128 and x % 16 == 0

    if dtype in (torch.float16, torch.bfloat16) \
            and (((width_ok(d) or d == 192) and width_ok(dv))
                 or d == dv == 256) \
            and g >= 1 and 64 % g == 0 \
            and all(x % 16 == 0 for x in ptrs_and_strides):
        return "wgmma"
    return "simt"


def attention_bwd_wide_smem_bytes(kb: int = 3, vb: int = 2) -> int:
    """Dynamic shared memory of the gradient's wide instance (D = 192, Dv
    up to 128) on the tensor cores (``bwd_tc_wide_smem_bytes`` in
    ``csrc/flash_attention_bwd.cu``): the alignment slack, the resident
    pair (K and V, or q and dO) and ``BWD_TC_STAGES`` stages of the
    streamed pair, D-wide operands ``kb`` 64-column boxes and Dv-wide ones
    ``vb`` (64 rows of 16-bit values a box), each stage's 64 rows of lse,
    delta and key end, and the full and empty barriers of each stage and
    the resident pair's: 125,480 bytes at (3, 2), one block an SM."""
    return 1024 + (1 + BWD_TC_STAGES) * (kb + vb) * 64 * 64 * 2 \
        + BWD_TC_STAGES * 3 * FLASH_BQ * 4 + 8 * (2 * BWD_TC_STAGES + 1)


def attention_bwd_w256_smem_bytes() -> int:
    """Dynamic shared memory of the gradients' 256-wide instance (D = Dv =
    256) on the tensor cores (``bwd_w_smem_bytes`` in
    ``csrc/attention_bwd.cuh``: row 10's passes and row 14's kernel): the
    alignment slack, the resident pair and ``BWD_TC_STAGES`` stages of the
    streamed pair at four 64-column boxes an operand, the exchange tiles
    (P and dS in the operand type, one box each, and P in f32), each
    stage's 64 rows of lse, delta and key end, the barriers and the
    loader's 128 bytes of state: 232,104 bytes, one block an SM."""
    box = 64 * 64 * 2
    return 1024 + (2 + 2 * BWD_TC_STAGES) * 4 * box + 2 * box \
        + 64 * 64 * 4 + BWD_TC_STAGES * 3 * FLASH_BQ * 4 \
        + 8 * (2 * BWD_TC_STAGES + 1) + 128


def expert_route(dtype, d: int, f: int, *ptrs_and_strides: int) -> str:
    """The route a grouped expert-MLP launch takes in
    ``csrc/expert_mlp.cu`` and ``csrc/moe_dispatch.cu`` (both run the tile
    routines of ``csrc/expert_mlp.cuh``): ``"wgmma"`` (TMA and the tensor
    cores) for 16-bit operands whose model width d and expert width f are
    multiples of 64 and whose base pointers and byte strides
    (``ptrs_and_strides``: those TMA reads) are 16-byte aligned; ``"simt"``
    (the CUDA cores) otherwise.  f32 stays on the CUDA cores: TF32 would
    change its results."""
    if dtype in (torch.float16, torch.bfloat16) and d >= 64 and f >= 64 \
            and d % 64 == 0 and f % 64 == 0 \
            and all(x % 16 == 0 for x in ptrs_and_strides):
        return "wgmma"
    return "simt"


def expert_bwd_route(dtype, d: int, f: int, *ptrs_and_strides: int) -> str:
    """The route an expert-MLP gradient launch takes in
    ``csrc/expert_mlp_bwd.cu`` and ``csrc/moe_dispatch_bwd.cu`` (both run
    the passes of ``csrc/expert_bwd.cuh``): ``"wgmma"`` (TMA and the tensor
    cores) for 16-bit operands whose model width d and expert width f are
    multiples of 64 and whose base pointers and byte strides
    (``ptrs_and_strides``: those TMA reads) are 16-byte aligned; ``"simt"``
    (the CUDA cores) otherwise.  The forward's rule (:func:`expert_route`):
    f32 stays on the CUDA cores, as TF32 would change its results."""
    return expert_route(dtype, d, f, *ptrs_and_strides)


def expert_bwd_tiles(weight_sets: int, sources: int, C: int,
                     rows: Optional[int] = None) -> int:
    """Packed ``EXB_BR``-row tiles a tensor-core launch of the expert MLP's
    gradient sizes its buffers for, without reading the counts: each of
    ``weight_sets`` weight sets packs its live rows over ``sources`` blocks
    of ``C`` rows into ``ceil(rows / EXB_BR)`` tiles, so at most
    ``weight_sets * ceil(sources * C / EXB_BR)`` tiles, and, where the
    caller knows that the live rows of every set number ``rows`` at most
    (the dropless dispatch: every rank's tokens times top-k), at most
    ``ceil((rows + (EXB_BR - 1) * weight_sets) / EXB_BR)``.  The kernel
    traps where the counts need more (``exb_build_pack``)."""
    tiles = weight_sets * -(-sources * C // EXB_BR)
    if rows is not None:
        tiles = min(tiles, -(-(rows + (EXB_BR - 1) * weight_sets) // EXB_BR))
    return max(tiles, 1)


def expert_bwd_work_words(weight_sets: int, sources: int, tiles: int) -> int:
    """int32 words of that launch's work area (``exb_work_words`` in
    ``csrc/expert_bwd.cuh``): the tiles in use, each tile's weight set,
    each weight set's first tile and ``sources + 1`` row offsets, then,
    8-byte aligned, an int64 source-row offset for every packed row."""
    meta = 1 + tiles + weight_sets * (sources + 2)
    return meta + meta % 2 + 2 * tiles * EXB_BR


def expert_bwd_scratch_elems(tiles: int, d: int, f: int) -> int:
    """Elements of that launch's scratch (``exb_planes``): the packed rows
    of x and dy (``d`` wide), then dg, du and h (``f`` wide)."""
    return tiles * EXB_BR * (2 * d + 3 * f)


def expert_bwd_smem_bytes() -> int:
    """Dynamic shared memory of an expert-MLP gradient block on the
    tensor-core route (``exb_smem_bytes`` in ``csrc/expert_bwd.cuh``): the
    alignment slack, the dW pass's ``EXB_STAGES`` stages of three 64 x 64
    16-bit boxes, ``EXB_SLOTS`` slots of four and ``EXB_OUT_TILES`` output
    tiles (the other passes' stages of up to ``EXB_BOXES`` boxes lie in the
    same bytes), and the full and empty mbarriers of each stage and of
    each slot."""
    return 1024 + (EXB_STAGES * 3 + 4 * EXB_SLOTS + EXB_OUT_TILES) \
        * 64 * 64 * 2 + 8 * (2 * EXB_STAGES + 2 * EXB_SLOTS)


def stencil_route(dtype, x: int, *ptrs_and_strides: int) -> str:
    """The route a wave-step launch takes in ``csrc/wave_step.cu``:
    ``"tma"`` (a ring of plane tiles fed by TMA, 16-byte vectors for prev,
    c2 and out) for f32 operands with X a multiple of 4 whose base pointers
    and byte strides (``ptrs_and_strides``: uext's, prev's, out's and a
    tensor c2's, batch, z and y) are multiples of 16; ``"simt"`` (one
    plane tile staged by the threads) otherwise.  Minimod's launches are
    all on the TMA route: (1024 + 8) x 4 = 4128-byte rows."""
    if dtype == torch.float32 and x % 4 == 0 \
            and all(v % 16 == 0 for v in ptrs_and_strides):
        return "tma"
    return "simt"


def scan_route(t: int) -> str:
    """The route a linear-scan launch of ``t`` rows takes in
    ``csrc/linear_scan.cu``: ``"decode"`` (one row: the state streamed
    through, one block per 16 of its rows) at ``t == 1``, ``"prefill"``
    (the chunked, sub-chunked scan) otherwise.  Both take any M, N <= 64;
    operands that are not contiguous f32 are refused before either."""
    return "decode" if t == 1 else "prefill"


def scan_instance(chunk: int) -> int:
    """Rows of the prefill-route block that takes chunks of ``chunk`` rows:
    the smallest of csrc/linear_scan.cu's instances (16, 32, 64) that
    holds them."""
    return 16 if chunk <= 16 else 32 if chunk <= 32 else 64


def scan_smem_bytes(ci: int, m: int, n: int) -> int:
    """Dynamic shared memory of a prefill-route scan block of ``ci`` rows
    (csrc/linear_scan.cu's ``scan_smem_bytes`` with M and N rounded up to
    4): two staged chunks of p, q, a and r, the weights A, the sub-chunk
    factors R~ and Q~, the state transposed, and the tables, in f32 with
    q, a and r rows padded by 4."""
    m4, n4 = -(-m // 4) * 4, -(-n // 4) * 4
    nsub = ci // SCAN_SUB
    return 4 * (2 * ci * (m4 + 3 * (n4 + 4)) + ci * (ci + 1)
                + 2 * ci * (n4 + 4) + n4 * m4
                + (nsub * (nsub + 3) // 2 + 1) * n4)


def expert_tile_n(rows: int) -> int:
    """The instance (wgmma's N) of a tensor-core expert-MLP row tile that
    holds ``rows`` live rows: the smallest of ``EX_TC_NS`` that holds them
    (``ex_tc_n`` in ``csrc/expert_mlp.cuh``)."""
    return next(n for n in EX_TC_NS if rows <= n or n == EX_TC_NS[-1])


def expert_live_tiles(live: Sequence[int], C: int) -> Tuple[int, ...]:
    """The work list the tensor-core expert-MLP route builds on the card
    from a pass's live-row counts (``ex_tc_build_list``): problem by
    problem, ``p * MT + t`` for each of the ``ceil(live / EX_TC_BR)`` row
    tiles of problem ``p`` (counts clamped to ``[0, C]``, ``MT = ceil(C /
    EX_TC_BR)``).  A problem with no live row gives no entry."""
    mt = -(-C // EX_TC_BR)
    return tuple(p * mt + t for p, n in enumerate(live)
                 for t in range(-(-min(max(int(n), 0), C) // EX_TC_BR)))


def expert_list_len(problems: int, C: int) -> int:
    """int32 entries the wrappers allocate for one pass's work list over
    ``problems`` problems of ``C`` rows: the count and at most every row
    tile (``ex_tc_list_len`` in ``csrc/expert_mlp.cuh``)."""
    return 1 + problems * -(-C // EX_TC_BR)


def expert_items(live: Sequence[int], C: int, cols: int
                 ) -> Tuple[Tuple[int, int, int, int], ...]:
    """The items of one pass over ``cols`` output columns (f for the
    gate/up pass, d for the down pass), in the order blocks take them (block
    ``b`` takes items ``b, b + grid, ...``): the 64-column tile fastest,
    then the list entry.  Each item is ``(problem, first row, rows, column
    tile)``; it runs the ``expert_tile_n(rows)`` instance."""
    tiles = expert_live_tiles(live, C)
    mt = -(-C // EX_TC_BR)
    items = []
    for e in tiles:
        for col in range(cols // EX_TC_TILE[0]):
            p, row0 = e // mt, (e % mt) * EX_TC_BR
            rows = min(min(max(int(live[p]), 0), C) - row0, EX_TC_BR)
            items.append((p, row0, rows, col))
    return tuple(items)


def plan_key_splits(blocks: int, keys: int, *, sms: int = SMS_DEFAULT
                    ) -> int:
    """Blocks that share one flash tile's keys on the tensor-core route.

    A grid of ``blocks`` (query tiles x kv heads x batch rows) that leaves
    the card mostly empty — a decode step: 8 blocks at glm4-9b's or
    paligemma-3b's decode on 2 ranks x 4 slots — splits each tile's keys
    into enough runs of whole ``ATT_TC_BK``-key tiles for the grid to cover
    the ``sms`` SMs about twice, at most one run per key tile of the
    ``keys`` a row may see.  A grid of ``sms`` blocks or more (prefill and
    chunk shapes) keeps one split.  The kernel balances the runs over the
    keys each tile really sees (:func:`key_split_tiles`)."""
    if blocks >= sms:
        return 1
    tiles = max(-(-keys // ATT_TC_BK), 1)
    return max(1, min(-(-2 * sms // max(blocks, 1)), tiles))


def key_split_tiles(tiles: int, splits: int) -> Tuple[Tuple[int, int], ...]:
    """The key tiles ``[lo, hi)`` each of ``splits`` runs takes of a query
    tile that sees ``tiles`` key tiles: split ``sp`` takes
    ``[sp tiles // splits, (sp + 1) tiles // splits)``, the rule of
    ``csrc/flash_attention.cu``'s ``flash_tc_kernel``.  Every tile falls
    in exactly one run; with fewer tiles than splits some runs are empty."""
    return tuple((sp * tiles // splits, (sp + 1) * tiles // splits)
                 for sp in range(splits))


def resolve_ring_impl(impl: Optional[str]) -> str:
    """Resolve a ring-matmul implementation knob to a concrete mode.

    ``"auto"``/None pick the fused bidirectional schedule; explicit
    ``"host"`` (the unidirectional host loop) and ``"fused"`` pass
    through.
    """
    if impl in (None, "auto"):
        return "fused"
    if impl in ("host", "fused"):
        return impl
    raise ValueError(f"unknown ring matmul impl {impl!r}")


def resolve_dispatch_impl(impl: Optional[str]) -> str:
    """Resolve a MoE dispatch implementation knob to a concrete mode.

    ``"auto"``/None keep the host collective ``"a2a"`` path; the dropless
    one-sided ``"host"`` and ``"fused"`` paths are explicit opt-ins (they
    change the numbers whenever the capacity path would drop tokens).  The
    step builders call this once per built step.
    """
    if impl in (None, "auto"):
        return "a2a"
    if impl in ("a2a", "host", "fused"):
        return impl
    raise ValueError(f"unknown moe dispatch impl {impl!r}")


def resolve_seq_parallel(impl: Optional[str]) -> str:
    """Resolve the sequence-parallel attention knob to a concrete mode.

    ``"auto"``/None keep the collective ``"allgather"`` path (K/V gathered
    over the model group, then local flash attention); ``"ring"`` (K/V
    stripes rotated through the one-sided ring) is an explicit opt-in.  The
    step builders call this once per built step.
    """
    if impl in (None, "auto"):
        return "allgather"
    if impl in ("allgather", "ring"):
        return impl
    raise ValueError(f"unknown seq_parallel mode {impl!r}")


def split_extents(total: int, parts: int,
                  weights: Optional[Sequence[float]] = None,
                  *, minimum: int = 1) -> Tuple[int, ...]:
    """Proportional largest-remainder split of ``total`` into ``parts``.

    The asymmetric-decomposition primitive of the Minimod driver (per-rank
    Z extents proportional to rank weights).  Every extent is at least
    ``minimum``; with integral weights summing to ``total`` the split
    reproduces the weights exactly (largest-remainder assigns each raw
    quota its own floor).
    ``weights=None`` degrades to the near-even split, which also covers
    non-divisible grids — a non-divisible symmetric request is just the
    asymmetric path with unit weights.
    """
    if parts < 1:
        raise ValueError("parts must be >= 1")
    weights = tuple(weights) if weights is not None else (1,) * parts
    if len(weights) != parts:
        raise ValueError(f"{len(weights)} weights for {parts} parts")
    if min(weights) <= 0:
        raise ValueError("weights must be positive")
    if minimum * parts > total:
        raise ValueError(
            f"cannot give {parts} ranks at least {minimum} of {total} rows")
    wsum = float(sum(weights))
    raw = [total * w / wsum for w in weights]
    ext = [max(int(r), minimum) for r in raw]
    order = sorted(range(parts), key=lambda i: raw[i] - int(raw[i]),
                   reverse=True)
    i = 0
    while sum(ext) < total:
        ext[order[i % parts]] += 1
        i += 1
    donors = sorted(range(parts), key=lambda i: ext[i] - raw[i], reverse=True)
    i = 0
    while sum(ext) > total:
        j = donors[i % parts]
        if ext[j] > minimum:
            ext[j] -= 1
        i += 1
    return tuple(ext)


# ---------------------------------------------------------------------------
# ring schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingStep:
    """One compute step of the ring collective matmul.

    ``index`` is the step number ``s``; the clockwise stream holds the
    stripe of rank ``(me - s) % n`` at step ``s``, the counter-clockwise
    stream the stripe of rank ``(me + s) % n``.  ``send_*`` are the
    forwards launched at this step (they deliver step ``s + 1``'s
    stripes and overlap this step's GEMMs); ``slot`` is the stripe
    slot both streams use for step ``s``.
    """

    index: int
    compute_cw: bool
    compute_ccw: bool
    send_cw: bool
    send_ccw: bool
    slot: int


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Concrete slot/step plan for one ring collective matmul.

    ``direction``:

    * ``"bidi"`` — the fused default: both link directions carry one stripe
      per step, ``ceil((n - 1) / 2)`` exchange steps;
    * ``"cw"`` / ``"ccw"`` — unidirectional rings (``n - 1`` steps), kept
      for the host-loop benchmark mode and for exercising both directions.
    """

    n: int
    direction: str = "bidi"
    slots: int = 2
    tile: Tuple[int, int, int] = (256, 512, 256)
    stripe_bytes: int = 0
    staging_bytes: int = 0

    def __post_init__(self):
        if self.direction not in ("bidi", "cw", "ccw"):
            raise ValueError(f"unknown ring direction {self.direction!r}")
        if self.n < 1:
            raise ValueError("group size must be >= 1")

    @property
    def exchange_steps(self) -> int:
        """Ring steps that move data: ceil((n-1)/2) bidi, n-1 one-way."""
        if self.n <= 1:
            return 0
        if self.direction == "bidi":
            return (self.n - 1 + 1) // 2
        return self.n - 1

    def schedule(self) -> Tuple[RingStep, ...]:
        """The per-step schedule both the CUDA kernel and the emulation
        execute (compute steps = exchange_steps + 1)."""
        n = self.n
        if n == 1:
            return (RingStep(0, True, False, False, False, 0),)
        steps = []
        if self.direction == "bidi":
            s_cw = (n - 1 + 1) // 2          # cw serves the ring's left half
            s_ccw = (n - 1) // 2             # ccw the right half (no overlap)
            for s in range(s_cw + 1):
                steps.append(RingStep(
                    index=s,
                    compute_cw=s <= s_cw,            # s == 0 is the local stripe
                    compute_ccw=1 <= s <= s_ccw,
                    send_cw=s < s_cw,
                    send_ccw=s < s_ccw,
                    slot=s % self.slots,
                ))
        else:
            cw = self.direction == "cw"
            for s in range(n):
                steps.append(RingStep(
                    index=s,
                    compute_cw=cw or s == 0,
                    compute_ccw=(not cw) and s >= 1,
                    send_cw=cw and s < n - 1,
                    send_ccw=(not cw) and s < n - 1,
                    slot=s % self.slots,
                ))
        return tuple(steps)

    def sources(self, rank: int = 0) -> Tuple[int, ...]:
        """Stripe owners computed by ``rank``, in schedule order (oracle for
        coverage tests: must be a permutation of range(n))."""
        out = []
        for st in self.schedule():
            if st.compute_cw:
                out.append((rank - st.index) % self.n)
            if st.compute_ccw:
                out.append((rank + st.index) % self.n)
        return tuple(out)

    def fold_steps(self) -> Tuple[Tuple[str, int], ...]:
        """Rank-agnostic ``(direction, step)`` of each fold, in schedule
        order — the i-th entry describes where :meth:`sources`' i-th
        stripe came from (``("cw", s)`` = owner ``rank - s``, ``("ccw",
        s)`` = owner ``rank + s``).  The ring-attention backward keys its
        canonical cotangent routing off this list."""
        out = []
        for st in self.schedule():
            if st.compute_cw:
                out.append(("cw", st.index))
            if st.compute_ccw:
                out.append(("ccw", st.index))
        return tuple(out)


# ---------------------------------------------------------------------------
# ring attention schedule (sequence parallelism)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionRingPlan:
    """Concrete schedule for one sequence-parallel ring attention pass.

    The K/V stripes rotate through the same bidirectional ring as the
    collective matmul (the step records ARE :meth:`RingPlan.schedule`); the
    compute is a flash block per stripe whose partial-softmax states fold
    with the :mod:`~repro_torch.kernels.ring_attention.kernel` merge.  On
    top of the ring this plan adds:

    * **causal step skipping** — :meth:`computes` says whether ``rank``
      spends FLOPs on stripe ``src``.  A stripe whose keys all lie in the
      rank's future (or past ``valid_len``) is fully masked, its state is
      the merge identity, and skipping it leaves the carry bit for bit.
      Sends are never skipped, so skipping changes FLOPs, not wire bytes.
      ``q_offset=None`` means the query positions come from tensors
      (chunked prefill): nothing is skipped statically.
    * **wire-byte accounting** — K and V are separate one-sided puts: a
      pass makes ``2·(n-1)`` puts a rank, ``(n-1)·stripe_bytes`` of wire,
      the figure the RMATracker windows and the OMPCCL byte log report.
    * ``q_sharded=True`` is the training layout (rank ``r`` holds queries
      ``q_offset + r·tq_loc ..``); ``False`` the chunked-prefill layout
      (every rank holds the same ``tq_loc`` queries at ``q_offset``).

    ``block`` is the CUDA kernel's key tile; ``staging_bytes`` the device
    memory a rank's stripe slots and f32 carry pin.
    """

    n: int
    tq_loc: int
    tk_loc: int
    h: int                      # query heads
    kh: int                     # kv heads (stripe width on the wire)
    d: int
    dv: int
    b: int = 1
    itemsize: int = 4
    causal: bool = True
    q_sharded: bool = True
    q_offset: Optional[int] = 0     # None: offsets from tensors, no skip
    valid_len: Optional[int] = None  # None: all n*tk_loc key rows are real
    direction: str = "bidi"
    slots: int = 2
    block: int = 64
    overlap: bool = True            # False: serialized "host" listing
    staging_bytes: int = 0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("group size must be >= 1")
        if self.tq_loc < 1 or self.tk_loc < 1:
            raise ValueError("per-rank extents must be >= 1")
        if self.h % self.kh:
            raise ValueError(f"H={self.h} not divisible by KH={self.kh}")
        if self.direction not in ("bidi", "cw", "ccw"):
            raise ValueError(f"unknown ring direction {self.direction!r}")

    @property
    def ring(self) -> RingPlan:
        """The underlying exchange schedule (shared with the matmul ring)."""
        return RingPlan(n=self.n, direction=self.direction, slots=self.slots,
                        stripe_bytes=self.stripe_bytes)

    @property
    def exchange_steps(self) -> int:
        return self.ring.exchange_steps

    def schedule(self) -> Tuple[RingStep, ...]:
        return self.ring.schedule()

    def sources(self, rank: int = 0) -> Tuple[int, ...]:
        """Stripe owners delivered to ``rank``, in schedule (= merge) order."""
        return self.ring.sources(rank)

    def fold_steps(self) -> Tuple[Tuple[str, int], ...]:
        """Per-fold ``(direction, step)`` records (:meth:`RingPlan.
        fold_steps`)."""
        return self.ring.fold_steps()

    def q_lo(self, rank: int) -> int:
        """First global query position of ``rank`` (static plans only)."""
        if self.q_offset is None:
            raise ValueError("dynamic q_offset has no static query range")
        return self.q_offset + (rank * self.tq_loc if self.q_sharded else 0)

    def computes(self, rank: int, src: int) -> bool:
        """Does ``rank`` spend FLOPs on stripe ``src``?  False only when
        every (query, key) pair of the stripe is masked."""
        k_lo = src * self.tk_loc
        if self.valid_len is not None and k_lo >= self.valid_len:
            return False
        if not self.causal or self.q_offset is None:
            return True
        return k_lo <= self.q_lo(rank) + self.tq_loc - 1

    def computed_sources(self, rank: int = 0) -> Tuple[int, ...]:
        return tuple(s for s in self.sources(rank) if self.computes(rank, s))

    @property
    def stripe_bytes(self) -> int:
        """Wire bytes of one K/V stripe (K put + V put)."""
        return self.b * self.tk_loc * self.kh * (self.d + self.dv) \
            * self.itemsize

    @property
    def puts_per_rank(self) -> int:
        """One-sided puts per rank per pass (K and V put separately)."""
        return 2 * (self.n - 1)

    @property
    def wire_bytes(self) -> int:
        """Per-rank put bytes of the pass: every remote stripe crosses each
        link once whatever the causal skip."""
        return (self.n - 1) * self.stripe_bytes

    @property
    def stripe_flops(self) -> int:
        """FLOPs of one stripe's block: QK^T and PV over all local queries
        and the ``h`` query heads."""
        return 2 * self.b * self.tq_loc * self.tk_loc * self.h \
            * (self.d + self.dv)

    def flops(self, rank: int) -> int:
        """FLOPs ``rank`` spends after causal step skipping."""
        return len(self.computed_sources(rank)) * self.stripe_flops


# ---------------------------------------------------------------------------
# halo schedule (Minimod)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Concrete slab/slot plan for one fused halo-overlapped stencil step.

    The schedule the fused Minimod step executes (CUDA kernel and
    emulation alike — see :mod:`repro_torch.kernels.stencil.fused`):

    * **carried halos** (the multi-step time loop): the R-thick *boundary*
      output slabs are computed FIRST (they only need the halos that landed
      last step), their values are immediately put one-sided to the
      neighbors (they are the neighbors' next-step halos), and the
      *interior* — which needs no halo at all — computes under the
      in-flight exchange.  One neighbor barrier/fence per step.
    * **single step** (no carried halos): the current field's boundary
      slabs are put first, the interior computes under the exchange, and
      the boundary region computes after the fence.

    ``overlap=False`` is the planner's *fallback* plan (degenerate grids
    with no interior, or a shared-memory budget too small to double-buffer
    the staging): exchange-then-compute, still numerically identical.

    Extents are LOCAL (the per-rank maximum when extents are asymmetric).
    ``slab_bytes``/``strip_bytes`` are the wire sizes of one Z-slab /
    Y-strip halo put; ``slots`` is the number of staging buffers granted by
    ``StreamPool.plan_slots`` against the shared-memory budget.  The Z chunk
    of each wave-step pass is not part of the plan: ``leap`` asks the
    planner's ``plan_stencil_bz`` for the shape of the pass it launches.
    """

    nz: int
    ny: int = 1
    halo: int = 4
    z_loc: int = 0
    y_loc: int = 0
    x: int = 0
    slots: int = 2
    slab_bytes: int = 0
    strip_bytes: int = 0
    staging_bytes: int = 0
    overlap: bool = True

    def __post_init__(self):
        if self.nz < 1 or self.ny < 1:
            raise ValueError("halo decomposition needs nz, ny >= 1")
        if self.halo < 1:
            raise ValueError("halo must be >= 1")

    @property
    def exchange_axes(self) -> Tuple[str, ...]:
        """Sharded axes that actually exchange (edge groups of 1 don't)."""
        axes = []
        if self.nz > 1:
            axes.append("z")
        if self.ny > 1:
            axes.append("y")
        return tuple(axes)

    @property
    def interior_z(self) -> int:
        return max(self.z_loc - 2 * self.halo, 0) if self.nz > 1 else self.z_loc

    @property
    def interior_y(self) -> int:
        return max(self.y_loc - 2 * self.halo, 0) if self.ny > 1 else self.y_loc

    @property
    def puts_per_step(self) -> int:
        """One-sided puts each step issues (2 per exchanging axis)."""
        return 2 * len(self.exchange_axes)

    @property
    def halo_bytes_per_step(self) -> int:
        return (2 * self.slab_bytes if self.nz > 1 else 0) + \
            (2 * self.strip_bytes if self.ny > 1 else 0)

    def schedule(self, *, carried: bool = True) -> Tuple[str, ...]:
        """Ordered phase names both executions follow.

        ``carried=True`` is the time-loop order (halos of the current field
        already landed; the step exchanges the freshly computed boundary),
        ``carried=False`` the single-step order (exchange the current
        field's slabs, compute the interior under it).
        """
        if not self.exchange_axes:
            return ("all",)
        if not self.overlap:
            return ("put", "fence", "all")
        if carried:
            return ("boundary", "put", "interior", "fence")
        return ("put", "interior", "fence", "boundary")


# ---------------------------------------------------------------------------
# MoE dispatch schedule (expert-parallel all-to-all)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllToAllPlan:
    """Concrete schedule for one dropless expert-parallel MoE dispatch.

    The ragged token→expert traffic is a ring of one-sided puts: at step
    ``s`` every rank puts the block destined for the rank ``s + 1`` ahead
    (the exchange that feeds step ``s + 1``), runs the expert GEMMs on the
    block that landed from the rank ``s`` behind (step 0 computes the local
    block), and puts that result straight back to its source.  One fence
    per landed block, one final fence for the combine windows.  The CUDA
    kernel and the emulation both execute exactly :meth:`schedule`.

    Capacities are per expert and **asymmetric** (``caps[e]`` rows per
    source rank, sized from measured load by
    :meth:`OverlapPlanner.plan_alltoall`): the home rank of expert ``e``
    registers a PGAS landing region of ``ep * caps[e]`` rows while the
    other ranks register none — the paper's asymmetric allocation.  Every
    wire block pads to ``cap_pad = max(caps)`` rows an expert;
    :meth:`block_rows` gives the true per-destination row counts.
    """

    ep: int                    # EP group size (ring length)
    E: int                     # global expert count
    t_loc: int                 # tokens per rank entering dispatch
    k: int                     # experts per token
    d: int                     # model dim of one token row
    itemsize: int = 4
    caps: Tuple[int, ...] = ()  # per-expert landing rows per source rank
    slots: int = 2             # staging buffers granted by StreamPool
    overlap: bool = True       # False: puts, fence, GEMMs, puts, fence

    def __post_init__(self):
        if self.ep < 1:
            raise ValueError("EP group size must be >= 1")
        if self.E % self.ep != 0:
            raise ValueError(f"E={self.E} not divisible by ep={self.ep}")
        if len(self.caps) != self.E:
            raise ValueError(f"{len(self.caps)} caps for {self.E} experts")
        if self.caps and min(self.caps) < 1:
            raise ValueError("per-expert capacities must be >= 1")

    @property
    def E_loc(self) -> int:
        return self.E // self.ep

    @property
    def cap_pad(self) -> int:
        """Padded per-expert rows of one wire block (max over experts)."""
        return max(self.caps)

    @property
    def block_bytes(self) -> int:
        """Wire bytes of one padded dispatch/combine put."""
        return self.E_loc * self.cap_pad * self.d * self.itemsize

    def block_rows(self, rank: int) -> int:
        """True rows one source sends to ``rank`` (the asymmetric sizes of
        the PGAS regions; the wire block pads to ``E_loc * cap_pad``)."""
        lo = rank * self.E_loc
        return sum(self.caps[lo:lo + self.E_loc])

    @property
    def region_rows(self) -> Tuple[int, ...]:
        """Per-expert PGAS landing-region rows on the expert's home rank
        (``ep`` sources × ``caps[e]`` rows each)."""
        return tuple(self.ep * c for c in self.caps)

    @property
    def wire_bytes(self) -> int:
        """Modeled wire bytes per rank per dispatch+combine (true rows,
        remote destinations only; every rank is rank 0 in the model)."""
        remote = sum(self.block_rows(r) for r in range(1, self.ep))
        return 2 * remote * self.d * self.itemsize

    @property
    def staging_bytes(self) -> int:
        """Device memory the pipeline pins: ``slots`` padded blocks."""
        return self.slots * self.block_bytes

    def schedule(self) -> Tuple[Tuple[str, int], ...]:
        """Ordered ``(phase, ring_offset)`` records both executions follow.

        * ``("put", s)``   — one-sided put of my block for the rank ``s``
          ahead;
        * ``("fence", s)`` — complete the landing of the block from the
          rank ``s`` behind before its GEMM reads it;
        * ``("gemm", s)``  — expert GEMMs on that block (``s == 0`` is the
          local block);
        * ``("ret", s)``   — one-sided put of that result back to its
          source;
        * ``("fence_ret", 0)`` — final fence of the combine windows.

        ``overlap=False`` is the serialized ``"host"`` mode: all dispatch
        puts, the fences, all GEMMs, all combine puts, one fence.
        """
        if self.ep == 1:
            return (("gemm", 0),)
        out = []
        if self.overlap:
            for s in range(self.ep):
                if s + 1 < self.ep:
                    out.append(("put", s + 1))
                if s > 0:
                    out.append(("fence", s))
                out.append(("gemm", s))
                if s > 0:
                    out.append(("ret", s))
        else:
            out += [("put", s) for s in range(1, self.ep)]
            out += [("fence", s) for s in range(1, self.ep)]
            out += [("gemm", s) for s in range(self.ep)]
            out += [("ret", s) for s in range(1, self.ep)]
        out.append(("fence_ret", 0))
        return tuple(out)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OverlapPlanner:
    """Converts (StreamPool.plan_slots, shared-memory budget, shapes, group
    size) into the concrete plans the kernels consume."""

    pool: StreamPool = dataclasses.field(
        default_factory=lambda: StreamPool(MAX_ACTIVE_STREAMS_DEFAULT))
    smem_budget: int = SMEM_BUDGET_DEFAULT

    def _fits(self, working_set_bytes: int) -> bool:
        """Would the slots plan_slots grants fit the budget?  (plan_slots
        never grants fewer than 2: double buffering is the point.)"""
        slots = self.pool.plan_slots(working_set_bytes, self.smem_budget)
        return slots * working_set_bytes <= self.smem_budget

    # -- ring collective matmul ---------------------------------------------
    def plan_ring_matmul(self, t_loc: int, k: int, n_loc: int, dtype,
                         n: int, *, direction: str = "bidi") -> RingPlan:
        """Slot/step plan for the fused all-gather matmul.

        The stripe slots live in device memory.  Their budget is the bytes
        of the all-gathered X they stand in for (``n`` stripes per rank):
        the fused ring never pins more than the all-gather baseline would
        materialize.  The kernel floors the grant at the reuse-safe count
        (``fused._ring_slots``).
        """
        item = _itemsize(dtype)
        stripe = max(t_loc * k * item, 1)
        budget = max(n * stripe, 2 * stripe)
        ndir = 2 if direction == "bidi" else 1
        slots = self.pool.plan_slots(ndir * stripe, budget)
        # the grant is a concurrency bound; the pinned bytes must also fit
        slots = min(slots, max(budget // (ndir * stripe), 2))
        plan = RingPlan(n=n, direction=direction,
                        slots=1 if n == 1 else max(2, min(slots, n)),
                        tile=self.plan_matmul_tiles(t_loc, k, n_loc, dtype),
                        stripe_bytes=stripe)
        return dataclasses.replace(
            plan, staging_bytes=ndir * plan.slots * stripe)

    # -- blocked matmul tiles -----------------------------------------------
    def plan_matmul_tiles(self, m: int, k: int, n: int, dtype
                          ) -> Tuple[int, int, int]:
        """The (BM, BK, BN) tile of the route a dtype and shape take
        (:func:`gemm_route`), clipped to the problem.

        Both tiles are fixed at compile time and the kernels handle ragged
        edges themselves, so the planner only checks the stages against the
        budget: the tensor-core route's ``TC_STAGES`` 16-bit stages, the
        CUDA-core route's ``MM_STAGES`` f32 stages (:meth:`mm_smem_bytes`).
        """
        if gemm_route(dtype, k, n) == "wgmma":
            tile = TC_TILE
            fits = TC_STAGES * (tile[0] * tile[1] + tile[1] * tile[2]) * 2 \
                <= self.smem_budget
        else:
            tile = MM_TILE
            fits = self.mm_smem_bytes() <= self.smem_budget
        if not fits:
            raise ValueError(
                f"matmul tile {tile} does not fit a shared-memory budget "
                f"of {self.smem_budget} bytes")
        bm, bk, bn = tile
        return min(bm, m), min(bk, k), min(bn, n)

    @staticmethod
    def mm_smem_bytes() -> int:
        """Dynamic shared memory of a CUDA-core GEMM block (csrc/matmul.cuh
        ``mm_smem_bytes``): ``MM_STAGES`` f32 stages of A's (BK, BM) tile,
        k-major with ``MM_APAD`` floats after each k row, and B's (BK, BN)
        tile."""
        bm, bk, bn = MM_TILE
        return MM_STAGES * (bk * (bm + MM_APAD) + bk * bn) * 4

    # -- stencil ---------------------------------------------------------------
    def stencil_stage_bytes(self, y: int, x: int, dtype, *,
                            radius: int = 4, route: str = "tma") -> int:
        """Shared memory one wave-step block stages.  On the TMA route
        (Minimod's; what the halo plan sizes) the ring of
        ``STENCIL_STAGES`` f32 plane tiles with their rims, the alignment
        slack and the barriers, whatever the grid (the tile is fixed); on
        the CUDA cores one plane tile with its radius-wide rim, clipped to
        the grid.  The kernel computes in f32."""
        if route == "tma":
            ty, tx = STENCIL_TMA_TILE
            return 128 + STENCIL_STAGES * (ty + 2 * radius) \
                * (tx + 2 * radius) * 4 + 16 * STENCIL_STAGES
        ty, tx = STENCIL_TILE
        return (min(ty, y) + 2 * radius) * (min(tx, x) + 2 * radius) \
            * _itemsize(dtype)

    def plan_stencil_bz(self, z: int, y: int, x: int, dtype, *,
                        radius: int = 4, bz: int = 32,
                        route: str = "tma") -> int:
        """Z chunk one wave-step block walks on ``route``.

        ``bz`` exceeding the Z extent clamps to it, a tiny grid still yields
        a positive chunk, and a budget that cannot double-buffer even the
        route's plane stage bottoms out at ``bz == 1``.
        """
        bz = max(min(bz, z), 1)
        if not self._fits(self.stencil_stage_bytes(y, x, dtype,
                                                   radius=radius,
                                                   route=route)):
            return 1
        return bz

    # -- flash attention -------------------------------------------------------
    @staticmethod
    def flash_stage_bytes(d: int, dv: int, block: int) -> int:
        """Shared memory one flash-attention block stages (f32): q^T of a
        FLASH_BQ-row tile, and per key tile k^T, v and the probabilities."""
        return 4 * (d * (FLASH_BQ + 1) + d * (block + 1) + block * dv
                    + FLASH_BQ * (block + 1))

    @staticmethod
    def attention_tc_stage_bytes(d: int, dv: int) -> int:
        """Dynamic shared memory of an attention block on the tensor-core
        route (16-bit): the alignment slack, the q tile, ``ATT_TC_STAGES``
        stages of a 64-key k and v tile, and the stages' and q's full and
        empty mbarriers.  Every operand is whole 64-column boxes, so a width
        off 64 (D = 80) takes the box it partly fills whole, as
        ``att_tc_smem_bytes`` does."""
        def box(x):         # the bytes of x columns' 64-column boxes
            return -(-x // 64) * 64 * FLASH_BQ * 2

        return 1024 + box(d) + ATT_TC_STAGES * (box(d) + box(dv)) \
            + 8 * (2 * ATT_TC_STAGES + 2)

    @staticmethod
    def expert_tc_smem_bytes(mats: int) -> int:
        """Dynamic shared memory of an expert-MLP block on the tensor-core
        route (16-bit): the alignment slack, ``EX_TC_STAGES`` stages of
        ``mats`` (64 K x 64 columns) weight tiles (2 for the gate/up pass, 1
        for the down pass; the fused dispatch sizes for 2) and an
        ``EX_TC_BR``-row tile of 64 K columns, and each stage's full and
        empty mbarriers."""
        cols, k = EX_TC_TILE
        return 1024 + EX_TC_STAGES * (mats * cols * k * 2 + EX_TC_BR * k * 2) \
            + 16 * EX_TC_STAGES

    def plan_attention_block(self, tq: int, tk: int, d: int, dv: int, dtype,
                             *, block: int = 512) -> int:
        """Keys folded per online-softmax update.  On the tensor-core route
        (:func:`attention_route` of the dtype and head dims) the tile is
        fixed: ``ATT_TC_BK`` = 64, whatever ``block`` asks, once its stages
        fit the budget.  Otherwise the largest of the CUDA-core kernel's
        key tiles (64, 32, 16), at most ``block``, whose f32 shared-memory
        stage fits the budget; that kernel stages once (no double buffer),
        so one stage is what must fit.

        The plain version folds the same number of keys per update, so the
        two sum in the same blocks.  Raises when even the smallest tile does
        not fit, or ``Dv`` exceeds the kernel's ``FLASH_MAX_DV``.
        """
        del tq, tk
        if attention_route(dtype, d, dv, 1) == "wgmma" \
                and self.attention_tc_stage_bytes(d, dv) <= self.smem_budget:
            return ATT_TC_BK
        if dv <= FLASH_MAX_DV:
            for b in FLASH_BLOCKS:
                if b <= max(block, FLASH_BLOCKS[-1]) \
                        and self.flash_stage_bytes(d, dv, b) \
                        <= self.smem_budget:
                    return b
        raise ValueError(
            f"flash attention with D = {d}, Dv = {dv} does not fit the "
            f"kernel (Dv <= {FLASH_MAX_DV}) and a shared-memory budget of "
            f"{self.smem_budget} bytes")

    # -- ring attention -------------------------------------------------------
    def plan_ring_attention(self, b: int, tq_loc: int, tk_loc: int,
                            h: int, kh: int, d: int, dv: int, dtype, n: int,
                            *, causal: bool = True, q_sharded: bool = True,
                            q_offset: Optional[int] = 0,
                            valid_len: Optional[int] = None,
                            direction: str = "bidi",
                            overlap: bool = True) -> AttentionRingPlan:
        """Slot/block plan for the fused sequence-parallel attention ring.

        The stripe slots live in device memory.  Each direction's budget is
        the bytes of the all-gathered K/V they stand in for (``n`` stripes),
        as :meth:`plan_ring_matmul` and :meth:`plan_alltoall` budget theirs
        (the reference budgets 16 MiB of VMEM net of the resident queries
        and carry).  The key tile is :meth:`plan_attention_block`'s on the
        per-rank extents.  ``q_offset=None`` marks offsets that come from
        tensors (chunked prefill): the plan then skips nothing.
        """
        item = _itemsize(dtype)
        block = self.plan_attention_block(tq_loc, tk_loc, d, dv, dtype)
        stripe = max(b * tk_loc * kh * (d + dv) * item, 1)
        slots = self.pool.plan_slots(stripe, n * stripe)
        slots = min(slots, max(n, 2))
        carry = b * tq_loc * h * (2 + dv) * 4      # f32 (m, l, acc)
        plan = AttentionRingPlan(
            n=n, tq_loc=tq_loc, tk_loc=tk_loc, h=h, kh=kh, d=d, dv=dv, b=b,
            itemsize=item, causal=causal, q_sharded=q_sharded,
            q_offset=q_offset, valid_len=valid_len, direction=direction,
            slots=1 if n == 1 else max(2, min(slots, n)), block=block,
            overlap=overlap)
        ndir = 2 if direction == "bidi" else 1
        return dataclasses.replace(
            plan, staging_bytes=ndir * plan.slots * stripe + carry)

    # -- MoE dispatch all-to-all ----------------------------------------------
    def plan_alltoall(self, t_loc: int, d: int, k: int, E: int, ep: int,
                      dtype, *, loads: Optional[Sequence[int]] = None,
                      slack: float = 1.0, overlap: bool = True
                      ) -> AllToAllPlan:
        """Schedule + asymmetric capacities for one dropless MoE dispatch.

        ``loads`` are measured per-expert row counts — the maximum over
        source ranks of rows routed to each expert.  The budget
        ``ceil(sum(loads) * slack)`` is split over experts by the
        largest-remainder rule (:func:`split_extents`) and re-clamped to
        ``>= loads[e]``, so the plan is dropless by construction.
        ``loads=None`` (no measurement inside a step) gives every expert
        the worst case, ``t_loc`` rows.

        The landing and return slots live in device memory.  Their budget
        is the bytes of the all-to-all they stand in for (``ep`` blocks a
        rank), as :meth:`plan_ring_matmul` budgets its stripes: the fused
        ring never pins more than the collective would materialize, and it
        keeps ``overlap`` at every size.  (The reference's 16 MiB VMEM
        budget — or the 227 KB of shared memory in its place — would turn a
        1 MiB decode block or a 128 MiB chunk block of qwen3-moe into the
        serialized schedule.)
        """
        if E % ep != 0:
            raise ValueError(f"E={E} not divisible by ep={ep}")
        item = _itemsize(dtype)
        if loads is None:
            caps = (t_loc,) * E
        else:
            loads = tuple(int(l) for l in loads)
            if len(loads) != E:
                raise ValueError(f"{len(loads)} loads for {E} experts")
            total = max(int(-(-sum(loads) * slack // 1)),
                        sum(max(l, 1) for l in loads))
            weights = tuple(max(l, 1e-6) for l in loads)
            caps = split_extents(total, E, weights, minimum=1)
            caps = tuple(max(c, l) for c, l in zip(caps, loads))
        plan = AllToAllPlan(ep=ep, E=E, t_loc=t_loc, k=k, d=d,
                            itemsize=item, caps=caps, overlap=overlap)
        if ep == 1:
            return dataclasses.replace(plan, slots=1)
        block = max(plan.block_bytes, 1)
        budget = max(ep * block, 2 * block)
        slots = self.pool.plan_slots(block, budget)
        slots = max(2, min(slots, max(budget // block, 2)))
        return dataclasses.replace(plan, slots=min(slots, ep))

    # -- gradient buckets -----------------------------------------------------
    def plan_grad_buckets(self, cfg, mesh, ctx):
        """The DP gradient-reduction schedule
        (:mod:`repro_torch.distributed.buckets`), resolved through the one
        planner surface like every other plan: static-shape data, shared
        per (config, mesh, ctx) through ``plan_for_config``'s cache."""
        from ..distributed.buckets import plan_for_config

        return plan_for_config(cfg, mesh, ctx)

    # -- halo exchange (Minimod) ----------------------------------------------
    def plan_halo_slots(self, z_loc: int, y_loc: int, x: int, dtype,
                        nz: int, *, ny: int = 1, halo: int = 4) -> HaloPlan:
        """Slab/slot plan for the fused halo-overlapped stencil step.

        The landing windows live in device memory; what shared memory holds
        is the wave-step kernel's plane stage, ``slots`` of them granted by
        ``StreamPool.plan_slots``.  Falls back to ``overlap=False``
        (exchange-then-compute) when the local grid has no interior or the
        budget cannot double-buffer the stage.
        """
        item = _itemsize(dtype)
        slab = halo * y_loc * x * item if nz > 1 else 0
        strip = z_loc * halo * x * item if ny > 1 else 0
        stage = self.stencil_stage_bytes(y_loc, x, dtype, radius=halo)
        slots = self.pool.plan_slots(stage, self.smem_budget)
        slots = max(2, min(slots, max(self.smem_budget // max(stage, 1), 2)))
        plan = HaloPlan(
            nz=nz, ny=ny, halo=halo, z_loc=z_loc, y_loc=y_loc, x=x,
            slots=slots, slab_bytes=slab, strip_bytes=strip,
            staging_bytes=slots * stage, overlap=True)
        has_interior = plan.interior_z > 0 and plan.interior_y > 0
        overlap = bool(plan.exchange_axes) and has_interior and \
            2 * stage <= self.smem_budget
        if not overlap:
            plan = dataclasses.replace(plan, overlap=False, slots=1,
                                       staging_bytes=stage)
        return plan


_DEFAULT_PLANNER: Optional[OverlapPlanner] = None


def default_planner() -> OverlapPlanner:
    """The process-default planner, backed by the active DiompContext's
    StreamPool so ``max_active_streams`` governs kernel staging slots and
    host async lanes alike."""
    global _DEFAULT_PLANNER
    from ..core.context import default_context

    pool = default_context().streams
    if _DEFAULT_PLANNER is None or _DEFAULT_PLANNER.pool is not pool:
        _DEFAULT_PLANNER = OverlapPlanner(pool=pool)
    return _DEFAULT_PLANNER
