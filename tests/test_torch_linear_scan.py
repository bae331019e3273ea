"""The port's linear scan held against the JAX package's.

On the CPU the port's ``linear_scan`` runs its plain version, the
sequential scan; the same numpy inputs go through the reference's
``linear_scan(impl="ref")`` (its sequential oracle) at 1e-5 relative (both
f32, sums in another order) and through its chunked Pallas kernel in
interpret mode at 2e-4, the reference's own bound for the chunked form
(``tests/test_kernels.py:99-103``), at the decays of that sweep.  At the
served models' decays the Pallas kernel's clamp of exp(-L) at e^30 breaks
it; one test records that caveat, and the port's kernel (which never
clamps) is held to the sequential scan at those decays on the card
(``chip_smoke.SMALL_CHECKS["linear_scan"]``, run by
``tests/test_torch_cuda.py``).  The kernel's own factoring, its decode
route at T = 1 and its prefill route's chunks, sub-chunks and exponent
differences, is repeated in plain torch by ``linear_scan_emulated``, held
here against the reference's oracle at every decay and against its
Pallas kernel where that kernel's clamp holds.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ops import linear_scan as j_linear_scan
from repro.kernels.linear_scan.ref import linear_scan_ref as j_scan_ref

from repro_torch.kernels.linear_scan import kernel as ls_kernel
from repro_torch.kernels.linear_scan.ops import linear_scan

SWEEP = [  # the reference sweep's shapes (tests/test_kernels.py:85)
    (3, 64, 16, 8, True, 16),
    (2, 128, 32, 32, False, 64),
    (1, 32, 8, 24, True, 32),
    (4, 96, 64, 64, False, 32),
    (2, 64, 64, 16, True, 64),
]


def _inputs(seed, BH, T, M, N, decay=None, s0=False):
    """Inputs as the reference sweep draws them; ``decay`` fixes a."""
    rng = np.random.RandomState(seed)
    p = rng.randn(BH, T, M).astype(np.float32) * 0.5
    q = rng.randn(BH, T, N).astype(np.float32) * 0.5
    a = (np.full((BH, T, N), decay, np.float32) if decay is not None
         else rng.uniform(0.7, 0.999, (BH, T, N)).astype(np.float32))
    r = rng.randn(BH, T, N).astype(np.float32) * 0.5
    s = rng.randn(BH, M, N).astype(np.float32) if s0 else None
    return p, q, a, r, s


def _port(p, q, a, r, s0, pre):
    y, s = linear_scan(*(torch.from_numpy(x) for x in (p, q, a, r)),
                       None if s0 is None else torch.from_numpy(s0),
                       readout_pre=pre)
    return y.numpy(), s.numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


CASES = [(f"sweep{i}", BH, T, M, N, pre, None, False)
         for i, (BH, T, M, N, pre, _) in enumerate(SWEEP)]
CASES += [(f"{name}-{'pre' if pre else 'post'}", BH, T, M, N, pre, decay, s0)
          for pre in (True, False)
          for (name, BH, T, M, N, decay, s0) in [
              ("decode", 3, 1, 64, 64, None, True),
              ("ragged", 2, 37, 16, 40, None, False),
              ("carried", 2, 20, 32, 16, None, True),
              ("e-1", 2, 130, 64, 64, math.exp(-1.0), False),
              ("e-8", 2, 130, 64, 64, math.exp(-8.0), True)]]


@pytest.mark.parametrize("name,BH,T,M,N,pre,decay,s0", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_reference_scan(name, BH, T, M, N, pre, decay, s0):
    p, q, a, r, s = _inputs(0, BH, T, M, N, decay, s0)
    y, sf = _port(p, q, a, r, s, pre)
    wy, ws = j_linear_scan(p, q, a, r, s, readout_pre=pre, impl="ref")
    wy, ws = np.asarray(wy), np.asarray(ws)
    assert y.shape == wy.shape and sf.shape == ws.shape
    assert y.dtype == np.float32 and sf.dtype == np.float32
    assert _rel(y, wy) <= 1e-5 and _rel(sf, ws) <= 1e-5


@pytest.mark.parametrize("BH,T,M,N,pre,chunk", SWEEP)
def test_plain_matches_reference_pallas_interpret(BH, T, M, N, pre, chunk):
    """At the reference sweep's decays, [0.7, 0.999], the chunked Pallas
    kernel (interpret mode) agrees with the port's sequential scan."""
    p, q, a, r, _ = _inputs(1, BH, T, M, N)
    y, sf = _port(p, q, a, r, None, pre)
    wy, ws = j_linear_scan(p, q, a, r, readout_pre=pre, impl="pallas",
                           chunk=chunk, interpret=True)
    np.testing.assert_allclose(y, np.asarray(wy), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(sf, np.asarray(ws), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("pre", [True, False])
def test_state_carry(pre):
    """Chunked prefill: the state after the first half fed to the second
    half equals one scan over the whole sequence."""
    p, q, a, r, _ = _inputs(2, 2, 70, 16, 24)
    y, sf = _port(p, q, a, r, None, pre)
    y1, s1 = _port(p[:, :33], q[:, :33], a[:, :33], r[:, :33], None, pre)
    y2, s2 = _port(p[:, 33:], q[:, 33:], a[:, 33:], r[:, 33:], s1, pre)
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5 * np.abs(y).max())
    np.testing.assert_allclose(s2, sf, rtol=1e-5, atol=1e-5 * np.abs(sf).max())


@pytest.mark.parametrize("pre,decay,first_bad",
                         [(True, math.exp(-1.0), 31), (False, 0.5, 43)])
def test_reference_pallas_clamp_caveat(pre, decay, first_bad):
    """The reference's Pallas kernel clamps exp(-L) at e^30: once the
    cumulative log-decay of a chunk passes -30 (after 30 steps of e^-1,
    43 of 0.5), the pair (t, t-1) loses its factor of 1, so from that
    position of each chunk on (``first_bad``: 31 reading the state before
    the update, 43 after it) y is wrong, off by more than half of its
    largest magnitude.  Its final state stays right, and the port's plain
    version matches the sequential scan.  These are the decays the served
    models' random weights give (RWKV: exp(-exp(0)) = e^-1; Mamba2:
    exp(-softplus(0)) = 0.5)."""
    p, q, a, r, _ = _inputs(3, 2, 128, 64, 64, decay)
    wy, ws = (np.asarray(x) for x in j_linear_scan(
        p, q, a, r, readout_pre=pre, impl="ref"))
    py, ps = (np.asarray(x) for x in j_linear_scan(
        p, q, a, r, readout_pre=pre, impl="pallas", chunk=64,
        interpret=True))
    assert _rel(py, wy) > 0.5
    row_err = np.abs(py - wy).max(axis=(0, 2)) / np.abs(wy).max()
    for c0 in (0, 64):                     # each chunk of 64
        assert row_err[c0:c0 + first_bad].max() <= 2e-4
        assert row_err[c0 + first_bad] > 1e-3
    assert _rel(ps, ws) <= 2e-4
    y, sf = _port(p, q, a, r, None, pre)
    assert _rel(y, wy) <= 1e-5 and _rel(sf, ws) <= 1e-5


def test_op_routes_and_refuses():
    """CPU tensors take the plain version without a launch; the
    reference's ``impl="ref"``/``"pallas"`` and interpret mode are
    refused; shapes that disagree are refused."""
    p, q, a, r, _ = _inputs(4, 2, 5, 8, 4)
    t = [torch.from_numpy(x) for x in (p, q, a, r)]
    before = ls_kernel.linear_scan_kernel.launches
    y, s = linear_scan(*t, readout_pre=True)
    assert ls_kernel.linear_scan_kernel.launches == before
    wy, ws = ls_kernel.linear_scan_plain(*t, readout_pre=True)
    assert torch.equal(y, wy) and torch.equal(s, ws)
    for impl in ("ref", "pallas"):
        with pytest.raises(TypeError, match="impl"):
            linear_scan(*t, impl=impl)
    with pytest.raises(TypeError, match="interpret"):
        linear_scan(*t, interpret=True)
    with pytest.raises(ValueError, match="shapes"):
        linear_scan(t[0], t[1][:, :4], t[2], t[3])


# -- the kernel's factoring in plain torch (linear_scan_emulated) --------------

def _emulated(p, q, a, r, s0, pre, chunk=64):
    y, s = ls_kernel.linear_scan_emulated(
        *(torch.from_numpy(x) for x in (p, q, a, r)),
        None if s0 is None else torch.from_numpy(s0), readout_pre=pre,
        chunk=chunk)
    return y.numpy(), s.numpy()


DECAYS = {"range": None, "e-1": math.exp(-1.0), "e-8": math.exp(-8.0)}


def _rel0(got, want):
    """|err| over the largest |want|; a zero want (y at T = 1 from a zero
    state, read before the update) must be matched exactly."""
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("s0", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64, 130])
@pytest.mark.parametrize("decay", list(DECAYS), ids=list(DECAYS))
def test_emulation_matches_reference_oracle(decay, T, pre, s0):
    """The decode route (T = 1) and the prefill route's sub-chunked
    factoring (chunks of 64, sub-chunks of 16: T = 15, 16, 17 at a
    sub-chunk's edges, 130 over three chunks) against the reference's
    sequential oracle (``repro.kernels.linear_scan.ref.linear_scan_ref``)
    within 2e-4 of each output's largest magnitude; every output finite,
    e^-8 included (no exponent is positive, nothing is clamped)."""
    p, q, a, r, s = _inputs(5, 2, T, 16, 24, DECAYS[decay], s0)
    y, sf = _emulated(p, q, a, r, s, pre)
    s_ref = s if s0 else np.zeros((2, 16, 24), np.float32)
    wy, ws = (np.asarray(x) for x in j_scan_ref(p, q, a, r, s_ref,
                                                readout_pre=pre))
    assert np.isfinite(y).all() and np.isfinite(sf).all()
    assert y.shape == wy.shape and sf.shape == ws.shape
    assert _rel0(y, wy) <= 2e-4 and _rel0(sf, ws) <= 2e-4


@pytest.mark.parametrize("chunk", [16, 32, 37])
@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_emulation_other_chunks_match_reference_oracle(chunk, pre):
    """Chunks of 16 (one sub-chunk), 32 (the served chunk, two sub-chunks)
    and a ragged 37 (a block of 64 rows with 27 padded) at e^-1 with a
    carried state."""
    p, q, a, r, s = _inputs(6, 2, 100, 64, 64, math.exp(-1.0), True)
    y, sf = _emulated(p, q, a, r, s, pre, chunk)
    wy, ws = (np.asarray(x) for x in j_scan_ref(p, q, a, r, s,
                                                readout_pre=pre))
    assert _rel(y, wy) <= 2e-4 and _rel(sf, ws) <= 2e-4


@pytest.mark.parametrize("T,chunk", [(64, 64), (128, 64), (64, 32),
                                     (48, 16)])
@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_emulation_matches_reference_pallas_interpret(T, chunk, pre):
    """Where T is a multiple of the chunk and the decays, drawn from the
    reference sweep's [0.7, 0.999], keep the cumulative log-decay of a
    chunk above the Pallas kernel's clamp (-30), the emulation and the
    Pallas kernel in interpret mode agree within 2e-4."""
    p, q, a, r, _ = _inputs(7, 2, T, 32, 32)
    y, sf = _emulated(p, q, a, r, None, pre, chunk)
    wy, ws = (np.asarray(x) for x in j_linear_scan(
        p, q, a, r, readout_pre=pre, impl="pallas", chunk=chunk,
        interpret=True))
    assert _rel(y, wy) <= 2e-4 and _rel(sf, ws) <= 2e-4


def test_emulation_state_carry():
    """The emulation's state after a first prefill fed to a decode step
    (T = 1) equals one prefill over both."""
    p, q, a, r, _ = _inputs(8, 2, 66, 16, 24, math.exp(-1.0))
    y, sf = _emulated(p, q, a, r, None, True)
    y1, s1 = _emulated(p[:, :65], q[:, :65], a[:, :65], r[:, :65], None, True)
    y2, s2 = _emulated(p[:, 65:], q[:, 65:], a[:, 65:], r[:, 65:], s1, True)
    assert _rel(np.concatenate([y1, y2], 1), y) <= 1e-5
    assert _rel(s2, sf) <= 1e-5
