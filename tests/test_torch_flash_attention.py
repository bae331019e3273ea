"""The port's flash attention held against the JAX package's.

Every case of the reference's sweep (``tests/test_kernels.py:39``, block 8)
goes through the port's ``flash_attention`` on the CPU (its plain version)
and through the reference's ``impl="ref"`` oracle and its Pallas kernel in
interpret mode; further cases hold per-row ``q_offset`` / ``valid_len``,
rows that see no key and a GQA 16:1 decode tile against the reference's
oracle.  Tolerances: f32 2e-5 (both sum in f32, in another order), f16
2e-2 (the output is rounded to a 10-bit mantissa), as the reference's own
sweep states.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash

from repro_torch.core.context import DiompContext, use_default
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_kernel, flash_attention_plain, flash_attention_split_plain,
    flash_combine_kernel, flash_combine_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.plan import (FLASH_BQ, SMEM_BUDGET_DEFAULT,
                                      OverlapPlanner)

RNG = np.random.RandomState(0)

# the reference's sweep: B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, dtype
SWEEP = [
    (2, 16, 16, 4, 2, 64, 64, True, 0, 0, np.float32),
    (1, 8, 24, 4, 1, 32, 32, True, 16, 0, np.float32),
    (2, 12, 12, 6, 6, 64, 64, False, 0, 0, np.float32),
    (1, 20, 20, 8, 2, 64, 64, True, 0, 5, np.float32),
    (1, 1, 33, 4, 2, 64, 64, True, 32, 0, np.float32),
    (1, 16, 16, 4, 2, 32, 16, True, 0, 0, np.float32),   # MLA: Dv != D
    (2, 16, 16, 4, 4, 64, 64, True, 0, 0, np.float16),
    # head_dim 80 (stablelm-3b's), and 80 with Dv = 48 under a prefix window
    (1, 37, 37, 8, 8, 80, 80, True, 0, 0, np.float32),
    (2, 29, 40, 4, 2, 80, 48, True, 3, 17, np.float32),
]


@pytest.fixture(autouse=True)
def _cpu_context():
    with use_default(DiompContext(device="cpu")):
        yield


def _tol(dt):
    return 2e-2 if dt == np.float16 else 2e-5


def _port(q, k, v, **kw):
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return got.double().numpy()


@pytest.mark.parametrize("case", SWEEP, ids=[str(i) for i in range(len(SWEEP))])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_sweep_matches_reference(case, impl):
    B, Tq, Tk, H, KH, D, Dv, causal, off, pfx, dt = case
    q = RNG.randn(B, Tq, H, D).astype(dt)
    k = RNG.randn(B, Tk, KH, D).astype(dt)
    v = RNG.randn(B, Tk, KH, Dv).astype(dt)
    kw = dict(causal=causal, q_offset=off, prefix_len=pfx, block=8)
    want = np.asarray(j_flash(q, k, v, impl=impl, interpret=True, **kw),
                      np.float64)
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, want, atol=_tol(dt), rtol=_tol(dt))


@pytest.mark.parametrize("Tq,H,KH,D,Dv", [(1, 4, 4, 32, 32),
                                          (5, 8, 2, 16, 16),
                                          (1, 16, 1, 128, 128)])
def test_per_row_offsets_match_reference(Tq, H, KH, D, Dv):
    """(B,) q_offset / valid_len: per-slot decode positions and a chunk
    over a running prefix; the last case is a decode tile at GQA 16:1."""
    B, Tk = 3, 40
    q = RNG.randn(B, Tq, H, D).astype(np.float32)
    k = RNG.randn(B, Tk, KH, D).astype(np.float32)
    v = RNG.randn(B, Tk, KH, Dv).astype(np.float32)
    pos = np.array([3, 17, 40 - Tq], np.int32)
    kw = dict(causal=True, q_offset=pos, valid_len=pos + Tq, block=8)
    want = np.asarray(j_flash(q, k, v, impl="ref", **kw), np.float64)
    got = _port(q, k, v, **{**kw, "q_offset": torch.from_numpy(pos),
                            "valid_len": torch.from_numpy(pos + Tq)})
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("Tq,Tk,H,KH,Dv,causal,pfx", [
    (37, 37, 4, 4, 80, True, 0),       # G = 1, causal
    (29, 45, 4, 2, 80, True, 11),      # G = 2, prefix-LM
    (21, 40, 2, 2, 48, True, 0),       # Dv != D
    (17, 33, 4, 2, 48, True, 9),
])
def test_head_dim_80_with_lse_matches_reference(Tq, Tk, H, KH, Dv, causal,
                                                pfx, impl):
    """The plain forward with ``return_lse`` at D = 80 (the widths the
    tensor-core route takes since they became whole 64-column boxes),
    valid_len below Tk: its output against the reference's oracle and
    Pallas kernel (interpret mode), f32 to 2e-5 as the sweep; its lse
    against the log-sum-exp of the scores in f64, to 1e-4 (f32 sums in
    another order)."""
    B, D = 2, 80
    rng = np.random.RandomState(Tq + Dv)
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tk, KH, D).astype(np.float32)
    v = rng.randn(B, Tk, KH, Dv).astype(np.float32)
    kw = dict(causal=causal, prefix_len=pfx, block=16, valid_len=Tk - 5)
    want = np.asarray(j_flash(q, k, v, impl=impl, interpret=True, **kw),
                      np.float64)
    got, lse = flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), return_lse=True, **kw)
    np.testing.assert_allclose(got.double().numpy(), want, atol=2e-5,
                               rtol=2e-5)
    G = H // KH
    s = np.einsum("bqhd,bkhd->bqhk", q.astype(np.float64),
                  np.repeat(k, G, axis=2).astype(np.float64)) * D ** -0.5
    qp, kp = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    vis = (kp <= qp) | ((kp < pfx) & (qp < pfx)) if causal else \
        np.ones((Tq, Tk), bool)
    vis = vis & (kp < Tk - 5)
    s = np.where(vis[None, :, None, :], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               atol=1e-4, rtol=1e-5)


def test_rows_that_see_no_key_are_zero():
    """valid_len 0 masks every key: the reference's guarded -inf path and
    the port both give 0, never NaN."""
    B, Tq, Tk, H, D = 2, 4, 16, 4, 32
    q = RNG.randn(B, Tq, H, D).astype(np.float32)
    k = RNG.randn(B, Tk, 2, D).astype(np.float32)
    v = RNG.randn(B, Tk, 2, D).astype(np.float32)
    valid = np.array([0, 9], np.int32)
    want = np.asarray(j_flash(q, k, v, impl="ref", valid_len=valid, block=8),
                      np.float64)
    got = _port(q, k, v, valid_len=torch.from_numpy(valid), block=8)
    assert np.all(got[0] == 0.0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_stacked_ranks_fold_into_the_batch():
    """Leading rank dims and a strided layer of a stacked cache give what
    each (rank, batch row) gives alone."""
    R, L, B, S, H, D = 2, 3, 2, 24, 8, 16
    cache = torch.randn(2, R, L, B, S, 2, D)
    q = torch.randn(R, B, 3, H, D)
    pos = torch.tensor([[0, 7], [20, 12]], dtype=torch.int32)
    got = flash_attention(q, cache[0, :, 1], cache[1, :, 1], q_offset=pos,
                          valid_len=pos + 3)
    for r in range(R):
        for b in range(B):
            want = flash_attention(
                q[r, b][None], cache[0, r, 1, b][None], cache[1, r, 1, b][None],
                q_offset=int(pos[r, b]), valid_len=int(pos[r, b]) + 3)
            torch.testing.assert_close(got[r, b], want[0], rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = torch.randn(2, 5, 4, 8), torch.randn(2, 9, 2, 8), \
        torch.randn(2, 9, 2, 8)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, q_offset=4, block=16)
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, q_offset=4, block=16))
    torch.testing.assert_close(
        got, flash_attention(q, k, v, q_offset=4, block=16))
    # block=None: the wrapper takes the planner's tile for both versions
    torch.testing.assert_close(flash_attention_kernel(q, k, v, q_offset=4),
                               flash_attention_plain(q, k, v, q_offset=4))
    assert flash_attention_kernel.launches == before


def test_ring_and_interpret_are_refused():
    """Only the kernel route is local: the reference's ``"ref"`` and
    ``"pallas"`` are refused, so no caller reaches the plain version on
    the card; ``"ring"`` (the sequence-parallel path) is refused without
    the group its stripes rotate over."""
    q = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match="DiompGroup"):
        flash_attention(q, q, q, impl="ring")
    with pytest.raises(ValueError, match="interpret"):
        flash_attention(q, q, q, interpret=True)
    for impl in ("ref", "pallas"):
        with pytest.raises(ValueError, match="unknown impl"):
            flash_attention(q, q, q, impl=impl)


def test_attention_block_fits_the_kernels_shared_memory():
    """The key tile is the largest of 64 / 32 / 16 whose f32 stage fits
    the H100's 227 KB of shared memory once (the kernel stages once; not
    the reference's 16 MiB of TPU VMEM), capped by ``block``."""
    p = OverlapPlanner()
    assert p.smem_budget == SMEM_BUDGET_DEFAULT == 232_448
    assert p.plan_attention_block(512, 4096, 128, 128, torch.bfloat16) == 64
    assert p.plan_attention_block(1, 4096, 80, 80, torch.bfloat16) == 64
    assert p.plan_attention_block(8, 8, 256, 256, torch.float32) == 64
    assert p.plan_attention_block(8, 8, 512, 256, torch.float32) == 16
    assert p.plan_attention_block(8, 8, 64, 64, torch.float32, block=32) == 32
    assert p.plan_attention_block(8, 8, 64, 64, torch.float32, block=8) == 16
    for d, dv in [(128, 128), (256, 256), (512, 256), (64, 16)]:
        b = p.plan_attention_block(1, 1, d, dv, torch.float32)
        stage = p.flash_stage_bytes(d, dv, b)
        assert stage == 4 * (d * (FLASH_BQ + 1) + d * (b + 1) + b * dv
                             + FLASH_BQ * (b + 1))
        assert stage <= SMEM_BUDGET_DEFAULT
        if b < 64:
            assert p.flash_stage_bytes(d, dv, 2 * b) > SMEM_BUDGET_DEFAULT
    with pytest.raises(ValueError, match="shared-memory budget"):
        p.plan_attention_block(1, 1, 1024, 64, torch.float32)
    with pytest.raises(ValueError, match="Dv <= 256"):
        p.plan_attention_block(1, 1, 64, 512, torch.float32)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 33])
@pytest.mark.parametrize("Tq,causal,pfx", [(1, True, 0), (6, True, 0),
                                           (6, False, 0), (6, True, 70)])
def test_key_split_and_merge_match_reference(splits, Tq, causal, pfx):
    """The decode split of the tensor-core route in plain torch — each
    row's keys cut into runs of whole 64-key tiles, one partial state a
    run, merged in split order with ``merge_states`` — against the
    reference's oracle: ragged valid lengths, a slot that sees one key (and
    one that sees none), G = 16, f32 (tolerance 2e-5, as the sweep's)."""
    rng = np.random.RandomState(17)
    B, Tk, H, KH, D, Dv = 4, 300, 16, 1, 32, 24
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k = rng.randn(B, Tk, KH, D).astype(np.float32)
    v = rng.randn(B, Tk, KH, Dv).astype(np.float32)
    valid = np.array([1, 130, 300, 0], np.int32)
    pos = np.maximum(valid - Tq, 0).astype(np.int32)
    kw = dict(causal=causal, q_offset=pos, valid_len=valid, prefix_len=pfx)
    want = np.asarray(j_flash(q, k, v, impl="ref", block=64, **kw),
                      np.float64)
    got = flash_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), splits,
        **{**kw, "q_offset": torch.from_numpy(pos),
           "valid_len": torch.from_numpy(valid)}).double().numpy()
    assert np.isfinite(got).all() and np.all(got[3] == 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_combine_wrapper_takes_plain_version_on_cpu():
    """The split combine on CPU tensors is its plain version (no launch
    counted); merging a run with the identity (m = -1e30, l = 0, acc = 0,
    as the kernel writes a run that saw no key) changes nothing, and a row
    that saw no key in any run comes out as 0."""
    g = torch.Generator().manual_seed(3)
    m = torch.randn(2, 4, 3, 5, generator=g)
    l = torch.rand(2, 4, 3, 5, generator=g) + 0.5
    acc = torch.randn(2, 4, 3, 5, 8, generator=g)
    m[:, 2], l[:, 2], acc[:, 2] = -1e30, 0.0, 0.0
    m[0, :, 1, 1], l[0, :, 1, 1], acc[0, :, 1, 1] = -1e30, 0.0, 0.0
    before = flash_attention_kernel.combine_launches
    got = flash_combine_kernel(m, l, acc, torch.float32)
    assert flash_attention_kernel.combine_launches == before
    torch.testing.assert_close(got, flash_combine_plain(m, l, acc,
                                                        torch.float32))
    keep = [0, 1, 3]
    torch.testing.assert_close(
        got, flash_combine_plain(m[:, keep], l[:, keep], acc[:, keep],
                                 torch.float32), rtol=1e-6, atol=1e-6)
    assert torch.all(got[0, 1, 1] == 0)
    # one run alone: the normalized state itself
    torch.testing.assert_close(
        flash_combine_plain(m[:, :1], l[:, :1], acc[:, :1], torch.float32),
        acc[:, 0] / l[:, 0, ..., None].clamp(min=1e-30))

