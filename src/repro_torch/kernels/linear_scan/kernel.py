"""The chunked linear-scan kernel (``csrc/linear_scan.cu``), its gradient
(``csrc/linear_scan_bwd.cu``) and their wrappers.

Replaces ``linear_scan_pallas`` (``repro/kernels/linear_scan/kernel.py:89``,
``pallas_call`` at :104).  It computes :func:`.ref.linear_scan_ref` at any
decay: unlike the Pallas kernel it never clamps, since every exponent it
takes is a difference of cumulative log-decays that is at most zero (the
CUDA source says why the clamp is wrong and what bounds the kernel).  A
launch takes the route :func:`..plan.scan_route` picks (counted in
``linear_scan_kernel.route_launches``): ``"decode"`` streams the state at
T = 1, ``"prefill"`` runs the chunked scan with sub-chunks of
``SCAN_SUB`` rows.  On CPU tensors the wrapper computes the plain version;
:func:`linear_scan_emulated` repeats the prefill route's factoring in
plain torch for the CPU tests (nothing on the serving path calls it).

The gradient has no TPU kernel (the reference differentiates its
sequential oracle): :func:`linear_scan_bwd_kernel` runs the hand-written
reverse chunked scan on the card and the plain reverse scan
(:func:`.ref.linear_scan_bwd_plain`) on CPU tensors, and returns the
gradient with respect to log a, never da = dla / a, which has no finite
value where the decay underflows.  :func:`linear_scan_bwd_emulated`
repeats its factoring for the CPU tests, and :class:`LinearScanFn` joins
the two kernels for autograd on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check_launch, library, stream_handle
from ..plan import SCAN_CHUNK, SCAN_ROUTES, SCAN_SUB, scan_instance, scan_route
from .ref import linear_scan_bwd_plain, linear_scan_ref

__all__ = ["linear_scan_kernel", "linear_scan_plain", "linear_scan_emulated",
           "linear_scan_bwd_kernel", "linear_scan_bwd_plain_dla",
           "linear_scan_bwd_emulated", "LinearScanFn", "MAX_CHUNK", "MAX_DIM", "BWD_CHUNK", "BWD_ROUTES",
           "TINY"]

MAX_CHUNK = 64   # rows of a chunk the kernel stages
MAX_DIM = 64     # largest M and N it takes
BWD_CHUNK = 16   # rows of a chunk of the backward (BWD_C)
BWD_ROUTES = ("chunked",)   # the backward's one route
TINY = 1e-38     # the decay both kernels clamp to before the log


def linear_scan_plain(p, q, a, r, s0=None, *, readout_pre: bool = True):
    """The plain version: the sequential scan, ``s0=None`` meaning zeros."""
    if s0 is None:
        s0 = torch.zeros(p.shape[0], p.shape[-1], q.shape[-1],
                         dtype=torch.float32, device=p.device)
    return linear_scan_ref(p, q, a, r, s0, readout_pre=readout_pre)


def _at(L: torch.Tensor, rows) -> torch.Tensor:
    """``L[:, rows]`` with row -1 reading as 0 (the chunk's start)."""
    Lz = torch.cat([torch.zeros_like(L[:, :1]), L], dim=1)
    return Lz[:, torch.as_tensor(rows) + 1]


def linear_scan_emulated(p, q, a, r, s0=None, *, readout_pre: bool = True,
                         chunk: int = SCAN_CHUNK):
    """The kernel's two routes in plain torch (f32): at T = 1 the decode
    route's ``S' = S diag(a) + p ⊗ q``; otherwise the prefill route's
    chunks of ``chunk`` rows laid out in blocks of ``scan_instance(chunk)``
    rows (padded with p = q = r = 0, a = 1), sub-chunks of ``SCAN_SUB``
    rows, per-pair exponentials only inside the diagonal sub-blocks and
    the factors ``R~ = r exp(Lr - L_b)``, ``Q~ = q exp(L_e - L)`` and
    ``D = exp(L_b - L_e)`` elsewhere, every exponent a difference <= 0.
    Returns ``(y (BH, T, M) in p.dtype, s_final (BH, M, N) f32)``."""
    BH, T, M = p.shape
    N = q.shape[-1]
    pf, qf, af, rf = (x.float() for x in (p, q, a, r))
    S = (torch.zeros(BH, M, N, dtype=torch.float32, device=p.device)
         if s0 is None else s0.float())
    if T == 1:
        S_new = S * af[:, 0, None, :] + pf[:, 0, :, None] * qf[:, 0, None, :]
        y = torch.einsum("bmn,bn->bm", S if readout_pre else S_new, rf[:, 0])
        return y[:, None].to(p.dtype), S_new
    ci = scan_instance(chunk)
    nsub = ci // SCAN_SUB
    t_idx = torch.arange(ci, device=p.device)
    sub = t_idx // SCAN_SUB
    lb_rows = SCAN_SUB * sub - 1                     # b_i: before sub-chunk
    le_rows = SCAN_SUB * sub + SCAN_SUB - 1          # e_j: its last row
    same = sub[:, None] == sub[None, :]
    vis = (t_idx[None, :] < t_idx[:, None]) if readout_pre \
        else (t_idx[None, :] <= t_idx[:, None])
    ys = []
    for c0 in range(0, T, chunk):
        rows = min(chunk, T - c0)

        def pad(x, fill):
            out = torch.full((BH, ci, x.shape[-1]), fill, dtype=torch.float32,
                             device=p.device)
            out[:, :rows] = x[:, c0:c0 + rows]
            return out

        pc, qc, rc = pad(pf, 0.0), pad(qf, 0.0), pad(rf, 0.0)
        L = torch.log(pad(af, 1.0).clamp_min(1e-38)).cumsum(1)
        Lr = _at(L, t_idx - 1) if readout_pre else L
        Rt = rc * torch.exp(Lr - _at(L, lb_rows))
        Qt = qc * torch.exp(L[:, le_rows] - L)
        # diagonal sub-blocks: per pair and channel
        diff = Lr[:, :, None, :] - L[:, None, :, :]          # (BH, t, s, N)
        keep = (same & vis)[None, :, :, None]
        wexp = torch.exp(torch.where(keep, diff, torch.full_like(diff,
                                                                 -torch.inf)))
        W = torch.einsum("btn,bsn,btsn->bts", rc, qc, wexp)
        # off-diagonal sub-blocks: R~ D Q~
        for i in range(1, nsub):
            ti = slice(SCAN_SUB * i, SCAN_SUB * i + SCAN_SUB)
            for j in range(i):
                sj = slice(SCAN_SUB * j, SCAN_SUB * j + SCAN_SUB)
                D = torch.exp(L[:, SCAN_SUB * i - 1]
                              - L[:, SCAN_SUB * j + SCAN_SUB - 1])
                W[:, ti, sj] = torch.einsum("btn,bn,bsn->bts", Rt[:, ti], D,
                                            Qt[:, sj])
        RH = Rt * torch.exp(_at(L, lb_rows))
        QH = Qt * torch.exp(L[:, -1:] - L[:, le_rows])
        y = W @ pc + RH @ S.transpose(1, 2)
        S = S * torch.exp(L[:, -1])[:, None, :] + pc.transpose(1, 2) @ QH
        ys.append(y[:, :rows])
    return torch.cat(ys, 1).to(p.dtype), S


def linear_scan_kernel(p, q, a, r, s0: Optional[torch.Tensor] = None, *,
                       readout_pre: bool = True, chunk: int = SCAN_CHUNK):
    """``p (BH, T, M)``; ``q, a, r (BH, T, N)``; ``s0 (BH, M, N)`` or None
    (zeros) -> ``(y (BH, T, M) in p.dtype, s_final (BH, M, N) f32)``.

    On the card every operand must be contiguous f32 on one device, with
    M, N <= 64 and ``chunk`` <= 64 (``SCAN_CHUNK`` rows by default, the
    served path's: two blocks an SM); any T >= 1 is taken (a ragged last
    chunk is masked).  One launch a call, on the decode route at T = 1 and
    the prefill route otherwise.
    """
    BH, T, M = p.shape
    N = q.shape[-1]
    if q.shape != (BH, T, N) or a.shape != q.shape or r.shape != q.shape \
            or (s0 is not None and s0.shape != (BH, M, N)):
        raise ValueError(f"linear scan shapes p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}, a {tuple(a.shape)}, r "
                         f"{tuple(r.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if not p.is_cuda:
        return linear_scan_plain(p, q, a, r, s0, readout_pre=readout_pre)
    ops = (p, q, a, r) + (() if s0 is None else (s0,))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != p.device for t in ops):
        got = ", ".join(
            f"{t.dtype}{'' if t.is_contiguous() else ' strided'} on "
            f"{t.device}" for t in ops)
        raise TypeError(f"linear scan kernel takes contiguous float32 "
                        f"operands on one device, got {got}")
    if M > MAX_DIM or N > MAX_DIM or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"linear scan kernel takes M, N <= {MAX_DIM} and a "
                         f"chunk of 1..{MAX_CHUNK}, got M {M}, N {N}, chunk "
                         f"{chunk}")
    route = scan_route(T)
    y = torch.empty(BH, T, M, dtype=torch.float32, device=p.device)
    s_fin = torch.empty(BH, M, N, dtype=torch.float32, device=p.device)
    status = library("linear_scan").repro_linear_scan(
        p.data_ptr(), q.data_ptr(), a.data_ptr(), r.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
        BH, T, M, N, min(chunk, T), int(readout_pre),
        SCAN_ROUTES.index(route), stream_handle(p.device))
    linear_scan_kernel.launches += 1
    linear_scan_kernel.route_launches[route] += 1
    check_launch(status, "linear scan")
    return y, s_fin


linear_scan_kernel.launches = 0
linear_scan_kernel.route_launches = dict.fromkeys(SCAN_ROUTES, 0)


def linear_scan_bwd_plain_dla(p, q, a, r, s0, dy, ds_fin=None, *,
                              readout_pre: bool = True):
    """The backward kernel's plain version: the plain reverse scan, with
    da turned into the gradient with respect to log a of the kernels'
    function, which reads log max(a, TINY): a * da, and 0 below TINY (flat
    there).  Returns ``(dp, dq, dla, dr, ds0)``."""
    dp, dq, da, dr, ds0 = linear_scan_bwd_plain(
        p, q, a, r, s0, dy, ds_fin, readout_pre=readout_pre)
    dla = torch.where(a < TINY, torch.zeros_like(da), a.float() * da)
    return dp, dq, dla, dr, ds0


def linear_scan_bwd_emulated(p, q, a, r, s0, dy, ds_fin=None, *,
                             readout_pre: bool = True,
                             chunk: int = BWD_CHUNK):
    """The backward kernel's factoring in plain torch (f32): a forward
    pass keeping each chunk's starting state, then the chunks in reverse
    with the carried cotangent K (the cotangent of the state after the
    chunk's last row), the per-pair exponentials ``E = exp(Lr_u - L_s)``
    (every exponent <= 0) inside a chunk, and dla from the terms of ``a_t
    Σ_m G_t ⊙ S_{t-1}``, each of which carries a_t's factor, so nothing
    cancels where the decays are strong.  Returns ``(dp, dq, dla, dr,
    ds0)`` (the CUDA source states the terms)."""
    pf, qf, af, rf, gy = (x.float() for x in (p, q, a, r, dy))
    BH, T, M = pf.shape
    N = qf.shape[-1]
    dev = pf.device
    S = (torch.zeros(BH, M, N, dtype=torch.float32, device=dev)
         if s0 is None else s0.float())
    starts, logs = [], []
    for c0 in range(0, T, chunk):
        rows = slice(c0, min(c0 + chunk, T))
        L = torch.log(af[:, rows].clamp_min(TINY)).cumsum(1)
        starts.append(S)
        logs.append(L)
        S = S * torch.exp(L[:, -1])[:, None, :] + pf[:, rows].transpose(1, 2) \
            @ (qf[:, rows] * torch.exp(L[:, -1:] - L))
    K = torch.zeros_like(S) if ds_fin is None else ds_fin.float()
    dp, dq, dla, dr = (torch.empty_like(x) for x in (pf, qf, af, rf))
    for ci in range(len(starts) - 1, -1, -1):
        L, S0, c0 = logs[ci], starts[ci], ci * chunk
        n = L.shape[1]
        rows = slice(c0, c0 + n)
        pc, qc, rc, yc = pf[:, rows], qf[:, rows], rf[:, rows], gy[:, rows]
        Lr = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], 1) \
            if readout_pre else L
        L_end = L[:, -1:]
        t = torch.arange(n, device=dev)
        rho = t - 1 if readout_pre else t         # the state row u reads
        vis = t[None, :] <= rho[:, None]           # (u, s)
        diff = Lr[:, :, None, :] - L[:, None, :, :]          # (BH, u, s, N)
        E = torch.exp(torch.where(vis[None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
        A = torch.einsum("bun,bsn,busn->bus", rc, qc, E)
        P = (yc @ pc.transpose(1, 2)) * vis
        Eq = torch.exp(L_end - L)
        dp[:, rows] = A.transpose(1, 2) @ yc + (qc * Eq) @ K.transpose(1, 2)
        drS = torch.exp(Lr) * (yc @ S0)
        dqK = Eq * (pc @ K)
        dr[:, rows] = drS + torch.einsum("bus,bsn,busn->bun", P, qc, E)
        dq[:, rows] = dqK + torch.einsum("bus,bun,busn->bsn", P, rc, E)
        # dla_t: the K ⊙ S_start term, the K term of dq before t, the
        # S_start term of dr from the rows that read a state at or after t,
        # and the pairs (u, s) with s < t <= rho(u)
        before = t[None, :] < t[:, None]                     # (t, s)
        reads = rho[None, :] >= t[:, None]                   # (t, u)
        strad = reads[:, :, None] & before[:, None, :]       # (t, u, s)
        X = P[..., None] * rc[:, :, None, :] * qc[:, None, :, :] * E
        dla[:, rows] = (torch.exp(L_end) * (K * S0).sum(1, keepdim=True)
                        + torch.einsum("ts,bsn->btn", before.float(),
                                       qc * dqK)
                        + torch.einsum("tu,bun->btn", reads.float(), rc * drS)
                        + torch.einsum("tus,busn->btn", strad.float(), X))
        K = K * torch.exp(L_end) + yc.transpose(1, 2) @ (rc * torch.exp(Lr))
    dla = torch.where(af < TINY, torch.zeros_like(dla), dla)
    return dp, dq, dla, dr, K


def linear_scan_bwd_kernel(p, q, a, r, s0, dy, ds_fin=None, *,
                           readout_pre: bool = True):
    """The gradient of :func:`linear_scan_kernel` at ``(p, q, a, r, s0)``
    (``s0`` None: zeros) for the cotangents ``dy (BH, T, M)`` and
    ``ds_fin (BH, M, N)`` (None: zeros) -> ``(dp, dq, dla, dr, ds0)`` in
    f32, ``dla`` the gradient with respect to log a (0 where a < TINY).

    On the card every operand must be contiguous f32 on one device, M, N
    <= 64; one launch a call (``.launches``, ``.route_launches``), with a
    scratch of each 16-row chunk's starting state.  On CPU tensors: its
    plain version, :func:`linear_scan_bwd_plain_dla`."""
    BH, T, M = p.shape
    N = q.shape[-1]
    if q.shape != (BH, T, N) or a.shape != q.shape or r.shape != q.shape \
            or dy.shape != p.shape \
            or any(t is not None and t.shape != (BH, M, N)
                   for t in (s0, ds_fin)):
        raise ValueError(f"linear scan backward shapes p {tuple(p.shape)}, "
                         f"q {tuple(q.shape)}, a {tuple(a.shape)}, r "
                         f"{tuple(r.shape)}, dy {tuple(dy.shape)}")
    if not p.is_cuda:
        return linear_scan_bwd_plain_dla(p, q, a, r, s0, dy, ds_fin,
                                         readout_pre=readout_pre)
    ops = tuple(t for t in (p, q, a, r, s0, dy, ds_fin) if t is not None)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != p.device for t in ops):
        got = ", ".join(
            f"{t.dtype}{'' if t.is_contiguous() else ' strided'} on "
            f"{t.device}" for t in ops)
        raise TypeError(f"linear scan backward kernel takes contiguous "
                        f"float32 operands on one device, got {got}")
    if M > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"linear scan backward kernel takes M, N <= "
                         f"{MAX_DIM}, got M {M}, N {N}")
    dp = torch.empty_like(p)
    dq, dla, dr = (torch.empty_like(q) for _ in range(3))
    ds0 = torch.empty(BH, M, N, dtype=torch.float32, device=p.device)
    chunks = -(-T // BWD_CHUNK)
    states = torch.empty(BH, chunks, M, N, dtype=torch.float32,
                         device=p.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = library("linear_scan_bwd").repro_linear_scan_bwd(
        p.data_ptr(), q.data_ptr(), a.data_ptr(), r.data_ptr(), ptr(s0),
        dy.data_ptr(), ptr(ds_fin), dp.data_ptr(), dq.data_ptr(),
        dla.data_ptr(), dr.data_ptr(), ds0.data_ptr(), states.data_ptr(),
        BH, T, M, N, int(readout_pre), stream_handle(p.device))
    linear_scan_bwd_kernel.launches += 1
    linear_scan_bwd_kernel.route_launches["chunked"] += 1
    check_launch(status, "linear scan backward")
    return dp, dq, dla, dr, ds0


linear_scan_bwd_kernel.launches = 0
linear_scan_bwd_kernel.route_launches = dict.fromkeys(BWD_ROUTES, 0)


class LinearScanFn(torch.autograd.Function):
    """The scan on the card with its gradient: the forward kernel on
    ``a = exp(log_a)``, then the backward kernel, each one launch; the
    decay's gradient is the backward kernel's ``dla``.  ``y`` and
    ``s_final`` are the forward kernel's; a cotangent left unset reads as
    zeros."""

    @staticmethod
    def forward(fctx, p, q, log_a, r, s0, readout_pre, chunk):
        fctx.set_materialize_grads(False)
        a = torch.exp(log_a)
        y, s_fin = linear_scan_kernel(p, q, a, r, s0, readout_pre=readout_pre,
                                      chunk=chunk)
        fctx.save_for_backward(p, q, a, r, s0)
        fctx.readout_pre = readout_pre
        return y, s_fin

    @staticmethod
    def backward(fctx, dy, ds_fin):
        p, q, a, r, s0 = fctx.saved_tensors
        dy = torch.zeros_like(p) if dy is None else dy.float().contiguous()
        if ds_fin is not None:
            ds_fin = ds_fin.float().contiguous()
        dp, dq, dla, dr, ds0 = linear_scan_bwd_kernel(
            p, q, a, r, s0, dy, ds_fin, readout_pre=fctx.readout_pre)
        need = fctx.needs_input_grad
        return (dp if need[0] else None, dq if need[1] else None,
                dla if need[2] else None, dr if need[3] else None,
                ds0 if need[4] else None, None, None)
