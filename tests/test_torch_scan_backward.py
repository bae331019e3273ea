"""The linear scan's gradient (the port's row 11) held against the JAX
package's.

The reference has no backward kernel: it differentiates its sequential
oracle ``linear_scan_ref`` under AD.  The same numpy inputs and cotangents
go through ``jax.vjp`` of that oracle and through the port's

* ``linear_scan_bwd_plain``, the reverse sequential scan, which returns
  ``da`` itself: within 1e-5 of each gradient's largest magnitude (f32
  sums in another order);
* ``linear_scan_bwd_emulated``, the backward kernel's factoring (chunks
  of 32 rows in sub-chunks of 16: per-pair exponentials on the diagonal
  sub-blocks, ``R~ D Q~`` off them, the carried cotangent, dla's
  straddling pairs per pair inside a diagonal block and as prefix and
  suffix sums of dq's and dr's off-block terms across blocks), which
  returns the gradient with respect to log a, held against the
  reference's ``a * da``: within 1e-4 of each gradient's own largest
  magnitude (f32 sums in another order over the chunks, also at decays
  of e^-8 and e^-30, where the identity ``dla_t = Σ_{u >= t} (r_u ⊙ dr_u
  − q_u ⊙ dq_u)`` would cancel to noise);

for both readouts, ``s0`` absent (zeros) and given, a cotangent on
``s_final`` and none, T inside one sub-chunk, at the edges of sub-chunks
and chunks (31, 32, 33, 63, 64, 65) and across chunks with a ragged last one
(57, 100), decays from the reference sweep's [0.7, 0.999] and fixed at
e^-1, e^-8 and e^-30, and a row of decays below 1e-38 (0, 1e-40,
1e-39): finite gradients, equal to the reference's there too (the
kernels' function reads log max(a, 1e-38), flat below it, so its dla is 0
where the reference's a * da is below 1e-38 times da).  Through a
model's log-decay ``-exp(w_log)`` the gradient with respect to ``w_log``
is finite and equal to the reference's at such decays.  The autograd
Function's CPU path (the plain versions) is held against autograd of the
plain scan.  The CUDA kernel itself is held against the plain reverse
scan on the card (``chip_smoke.SMALL_CHECKS["linear_scan_bwd"]``).
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ref import linear_scan_ref as j_scan_ref

from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan import kernel as ls
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_plain,
                                                 linear_scan_ref)

BH, M, N = 2, 8, 12
DECAYS = {"range": None, "e-1": math.exp(-1.0), "e-8": math.exp(-8.0),
          "e-30": math.exp(-30.0)}
TINY_ROW = 5                      # the row of decays below 1e-38
TINY_VALUES = (0.0, 1e-40, 1e-39)


def _inputs(seed, T, decay=None, s0=False, ds_fin=False, tiny=False):
    """Inputs and cotangents as the reference's sweep draws them; ``tiny``
    puts decays below 1e-38 on a row of a few channels."""
    rng = np.random.RandomState(seed)
    p = rng.randn(BH, T, M).astype(np.float32) * 0.5
    q = rng.randn(BH, T, N).astype(np.float32) * 0.5
    a = (np.full((BH, T, N), decay, np.float32) if decay is not None
         else rng.uniform(0.7, 0.999, (BH, T, N)).astype(np.float32))
    if tiny:
        for c, v in enumerate(TINY_VALUES):
            a[:, TINY_ROW, c] = v
    r = rng.randn(BH, T, N).astype(np.float32) * 0.5
    s = rng.randn(BH, M, N).astype(np.float32) if s0 else None
    dy = rng.randn(BH, T, M).astype(np.float32)
    g = rng.randn(BH, M, N).astype(np.float32) if ds_fin else None
    return p, q, a, r, s, dy, g


@functools.lru_cache(maxsize=None)
def _vjp(key):
    """The reference's gradients ``(dp, dq, da, dr, ds0)`` of
    ``linear_scan_ref`` (``s0`` zeros where absent) at ``_inputs(*key[1:])``
    and readout ``key[0]``."""
    pre, *args = key
    p, q, a, r, s, dy, g = _inputs(*args)
    s = np.zeros((BH, M, N), np.float32) if s is None else s
    g = np.zeros((BH, M, N), np.float32) if g is None else g
    _, pull = jax.vjp(lambda *x: j_scan_ref(*x, readout_pre=pre),
                      *(jnp.asarray(x) for x in (p, q, a, r, s)))
    return tuple(np.asarray(x) for x in pull((jnp.asarray(dy),
                                              jnp.asarray(g))))


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _rel(got, want):
    """|err| over the largest |want| (a zero want matched exactly)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max()
    return err / np.abs(want).max() if np.abs(want).max() else err


CASES = [(pre, T, s0, g) for pre in (True, False) for T in (1, 16, 40)
         for s0 in (False, True) for g in (False, True)]
IDS = [f"{'pre' if pre else 'post'}-T{T}-{'s0' if s0 else 'zero'}-"
       f"{'dsfin' if g else 'nodsfin'}" for pre, T, s0, g in CASES]
EDGES = (31, 32, 33, 63, 64, 65, 100)   # about sub-chunk and chunk edges


@pytest.mark.parametrize("pre,T,s0,g", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(pre, T, s0, g):
    """The reverse sequential scan against ``jax.vjp`` of the reference's
    oracle: every gradient within 1e-5 of its largest magnitude."""
    args = _inputs(3, T, None, s0, g)
    got = linear_scan_bwd_plain(*(_torch(x) for x in args), readout_pre=pre)
    want = _vjp((pre, 3, T, None, s0, g))
    for name, x, w in zip(("dp", "dq", "da", "dr", "ds0"), got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        assert _rel(x, w) <= 1e-5, name


@pytest.mark.parametrize("pre,T,s0,g", CASES, ids=IDS)
def test_emulated_backward_matches_jax_vjp(pre, T, s0, g):
    """The kernel's chunked factoring against ``jax.vjp``: dp, dq, dr, ds0
    and dla (against the reference's ``a * da``) within 1e-4 of each
    gradient's largest magnitude."""
    args = _inputs(3, T, None, s0, g)
    got = ls.linear_scan_bwd_emulated(*(_torch(x) for x in args),
                                      readout_pre=pre)
    dp, dq, da, dr, ds0 = _vjp((pre, 3, T, None, s0, g))
    for name, x, w in zip(("dp", "dq", "dla", "dr", "ds0"), got,
                          (dp, dq, args[2] * da, dr, ds0)):
        assert _rel(x, w) <= 1e-4, name


@pytest.mark.parametrize("decay", ["range", "e-8", "e-30", "tiny"])
@pytest.mark.parametrize("T", EDGES)
@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_emulated_backward_across_chunk_edges(pre, T, decay):
    """The factoring at T across its 16-row sub-chunks and 32-row chunks
    (and a ragged last chunk), ``s0`` and ``ds_fin`` given, at the
    reference sweep's decays, e^-8, e^-30 and with a row of decays below
    1e-38: dp, dq, dr, ds0 and dla within 1e-4 of ``jax.vjp``'s,
    everything finite, dla 0 on the tiny decays."""
    tiny = decay == "tiny"
    key = (pre, 5, T, None if tiny else DECAYS[decay], True, True)
    args = _inputs(*key[1:], tiny=tiny)
    dp, dq, da, dr, ds0 = _vjp(key + ((True,) if tiny else ()))
    got = ls.linear_scan_bwd_emulated(*(_torch(x) for x in args),
                                      readout_pre=pre)
    for name, x, w in zip(("dp", "dq", "dla", "dr", "ds0"), got,
                          (dp, dq, args[2] * da, dr, ds0)):
        assert torch.isfinite(x).all(), name
        assert _rel(x, w) <= 1e-4, name
    if tiny:
        assert not got[2][:, TINY_ROW, :len(TINY_VALUES)].any()


@pytest.mark.parametrize("decay", list(DECAYS), ids=list(DECAYS))
@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_backwards_at_fixed_decays_and_across_chunks(pre, decay):
    """T = 57 (a whole chunk of 32 and a ragged one, three whole sub-chunks
    of 16 and a ragged one) at every decay,
    e^-8 and e^-30 included (no exponent positive, no term that cancels):
    the plain backward within 1e-5 and the emulated within 1e-4 of the
    reference's, everything finite."""
    key = (pre, 7, 57, DECAYS[decay], True, True)
    args = _inputs(*key[1:])
    want = _vjp(key)
    plain = linear_scan_bwd_plain(*(_torch(x) for x in args),
                                  readout_pre=pre)
    emu = ls.linear_scan_bwd_emulated(*(_torch(x) for x in args),
                                      readout_pre=pre)
    wla = args[2] * want[2]
    for i, name in enumerate(("dp", "dq", "da", "dr", "ds0")):
        assert torch.isfinite(plain[i]).all() and torch.isfinite(emu[i]).all()
        assert _rel(plain[i], want[i]) <= 1e-5, name
        assert _rel(emu[i], wla if i == 2 else want[i]) <= 1e-4, name


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_decays_below_1e38_give_finite_equal_gradients(pre):
    """A row of decays 0, 1e-40 and 1e-39: the plain backward's da is
    finite and within 1e-5 of the reference's; the emulation's and the
    wrapper's dla are finite, 0 on that row's tiny entries and within
    1e-4 of the reference's ``a * da`` everywhere."""
    key = (pre, 11, 40, None, True, True)
    args = _inputs(*key[1:], tiny=True)
    want = _vjp(key + (True,))
    plain = linear_scan_bwd_plain(*(_torch(x) for x in args),
                                  readout_pre=pre)
    assert all(torch.isfinite(x).all() for x in plain)
    for x, w in zip(plain, want):
        assert _rel(x, w) <= 1e-5
    wla = args[2] * want[2]
    for got in (ls.linear_scan_bwd_emulated(*(_torch(x) for x in args),
                                            readout_pre=pre),
                ls.linear_scan_bwd_kernel(*(_torch(x) for x in args),
                                          readout_pre=pre)):
        assert all(torch.isfinite(x).all() for x in got)
        assert not got[2][:, TINY_ROW, :len(TINY_VALUES)].any()
        for x, w in zip(got, (want[0], want[1], wla, want[3], want[4])):
            assert _rel(x, w) <= 1e-4


def test_log_decay_gradient_at_underflow_matches_reference():
    """RWKV's decay ``exp(-exp(w_log))`` underflows to 0 once ``w_log``
    passes about 4.47: the gradient with respect to ``w_log`` through the
    port's ``linear_scan(log_a=-exp(w_log))`` is finite, 0 where the
    decay is below 1e-38, and within 1e-4 of the reference's through its
    decay (``jax.vjp``), at w_log from -2 to 6."""
    rng = np.random.RandomState(2)
    T = 24
    p, q, _, r, _, dy, _ = _inputs(2, T)
    w_log = rng.uniform(-2.0, 6.0, (BH, T, N)).astype(np.float32)
    assert (np.exp(-np.exp(w_log)) < 1e-38).any()

    def ref(wl):
        y, _ = j_scan_ref(p, q, jnp.exp(-jnp.exp(wl)), r,
                          jnp.zeros((BH, M, N)), readout_pre=True)
        return y
    _, pull = jax.vjp(ref, jnp.asarray(w_log))
    want = np.asarray(pull(jnp.asarray(dy))[0])
    wl = torch.from_numpy(w_log).requires_grad_()
    y, _ = linear_scan(torch.from_numpy(p), torch.from_numpy(q), None,
                       torch.from_numpy(r), log_a=-torch.exp(wl))
    got, = torch.autograd.grad(y, wl, torch.from_numpy(dy))
    fn = ls.LinearScanFn.apply
    wl2 = torch.from_numpy(w_log).requires_grad_()
    y2, _ = fn(torch.from_numpy(p), torch.from_numpy(q), -torch.exp(wl2),
               torch.from_numpy(r), None, True, 32)
    got2, = torch.autograd.grad(y2, wl2, torch.from_numpy(dy))
    for g in (got, got2):
        assert torch.isfinite(g).all()
        assert _rel(g, want) <= 1e-4
    assert not got2[torch.from_numpy(np.exp(-np.exp(w_log)) < 1e-38)].any()


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "post"])
def test_function_cpu_path_is_the_plain_versions(pre):
    """``LinearScanFn`` on CPU tensors: y and s_final equal the plain
    scan's, and its gradients (dla for ``log_a``, ds0 for a given ``s0``,
    a cotangent on both outputs) equal autograd of the plain scan within
    1e-5; no launch is counted."""
    p, q, a, r, s, dy, g = _inputs(4, 37, None, True, True)
    la = np.log(a)
    before = (ls.linear_scan_kernel.launches,
              ls.linear_scan_bwd_kernel.launches)
    ins = [torch.from_numpy(x).requires_grad_() for x in (p, q, la, r, s)]
    y, sf = ls.LinearScanFn.apply(ins[0], ins[1], ins[2], ins[3], ins[4],
                                  pre, 32)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (sf * torch.from_numpy(g)).sum(), ins)
    ref_in = [torch.from_numpy(x).requires_grad_() for x in (p, q, la, r, s)]
    wy, ws = linear_scan_ref(ref_in[0], ref_in[1], torch.exp(ref_in[2]),
                             ref_in[3], ref_in[4], readout_pre=pre)
    want = torch.autograd.grad((wy * torch.from_numpy(dy)).sum()
                               + (ws * torch.from_numpy(g)).sum(), ref_in)
    assert torch.equal(y, wy) and torch.equal(sf, ws)
    for x, w in zip(got, want):
        assert _rel(x, w.numpy()) <= 1e-5
    assert (ls.linear_scan_kernel.launches,
            ls.linear_scan_bwd_kernel.launches) == before


def test_backward_wrapper_routes_and_refuses():
    """On CPU tensors the backward wrapper is the plain reverse scan with
    dla = a * da (no launch counted); shapes that disagree are refused;
    ``linear_scan`` takes exactly one of a and log_a."""
    p, q, a, r, s, dy, g = (_torch(x) for x in _inputs(6, 20, None, True,
                                                       True))
    before = ls.linear_scan_bwd_kernel.launches
    got = ls.linear_scan_bwd_kernel(p, q, a, r, s, dy, g, readout_pre=False)
    want = linear_scan_bwd_plain(p, q, a, r, s, dy, g, readout_pre=False)
    assert ls.linear_scan_bwd_kernel.launches == before
    for i, (x, w) in enumerate(zip(got, want)):
        assert torch.equal(x, a * w if i == 2 else w)
    with pytest.raises(ValueError, match="shapes"):
        ls.linear_scan_bwd_kernel(p, q, a, r, s, dy[:, :3], g)
    with pytest.raises(TypeError, match="one of a and log_a"):
        linear_scan(p, q, a, r, log_a=torch.log(a))
    with pytest.raises(TypeError, match="one of a and log_a"):
        linear_scan(p, q, None, r)


def test_backward_source_matches_the_wrapper():
    """``linear_scan_bwd.cu``'s chunk, sub-chunk, width limit, threads and
    blocks an SM against the wrapper's constants; its dynamic shared
    memory against ``scan_bwd_smem_bytes``: one block of it fits the card's
    227 KB of an SM and two do not, as the source states; the threads fill
    four warp groups and the registers of an SM at 128 a thread; the
    ctypes argument list against the C entry, parameter by parameter."""
    text = (_build.CSRC / "linear_scan_bwd.cu").read_text()
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    assert d["BWD_C"] == ls.BWD_CHUNK == 32
    assert d["BWD_SUB"] == ls.BWD_SUB == 16 and ls.BWD_CHUNK // ls.BWD_SUB == 2
    assert d["BWD_DMAX"] == ls.MAX_DIM
    assert d["BWD_THREADS"] == ls.BWD_THREADS == 4 * 128
    assert d["BWD_BLOCKS_PER_SM"] == ls.BWD_BLOCKS_PER_SM == 1
    assert 0 < d["BWD_SPLIT"] < d["BWD_SUB"]
    assert float(re.search(r"#define BWD_TINY ([\d.e+-]+)f", text)
                 .group(1)) == ls.TINY
    assert re.search(r"#define BWD_RS \(BWD_DMAX \+ 4\)", text)
    assert re.search(r"#define BWD_PS \(BWD_C \+ 4\)", text)
    assert re.search(r"__launch_bounds__\(BWD_THREADS, BWD_BLOCKS_PER_SM\)",
                     text)
    expr = re.search(r"scan_bwd_smem_bytes\(\) \{\s*return ([^;]+);",
                     text).group(1)
    smem = eval(" ".join(expr.split()), {
        "BWD_C": 32, "BWD_DMAX": 64, "BWD_RS": 68, "BWD_PS": 36})
    assert smem == ls.scan_bwd_smem_bytes() == 204_048
    assert f"{smem:,} bytes" in " ".join(text.split())
    assert ls.BWD_BLOCKS_PER_SM * smem <= 232_448 < 2 * smem
    assert ls.BWD_BLOCKS_PER_SM * ls.BWD_THREADS * 128 <= 65_536
    source, fns = _build.LIBRARIES["linear_scan_bwd"]
    assert source == "linear_scan_bwd.cu"
    params = re.search(r'extern "C" int repro_linear_scan_bwd\(([^)]*)\)',
                       text).group(1)
    kinds = [_build._P if "*" in " ".join(par.split()) else _build._I
             for par in params.split(",")]
    assert kinds == fns["repro_linear_scan_bwd"]
    assert set(ls.linear_scan_bwd_kernel.route_launches) == set(ls.BWD_ROUTES)
