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
           "linear_scan_bwd_emulated", "LinearScanFn", "MAX_CHUNK", "MAX_DIM",
           "BWD_CHUNK", "BWD_SUB", "BWD_THREADS", "BWD_BLOCKS_PER_SM",
           "BWD_ROUTES", "TINY", "scan_bwd_smem_bytes"]

MAX_CHUNK = 64   # rows of a chunk the kernel stages
MAX_DIM = 64     # largest M and N it takes
BWD_CHUNK = 32   # rows of a chunk of the backward (BWD_C)
BWD_SUB = 16     # rows of its sub-chunks (BWD_SUB)
BWD_THREADS = 512  # threads of its block, one a sequence (BWD_THREADS)
BWD_BLOCKS_PER_SM = 1  # blocks its shared memory lets an SM hold
BWD_ROUTES = ("chunked",)   # the backward's one route
TINY = 1e-38     # the decay both kernels clamp to before the log


def scan_bwd_smem_bytes() -> int:
    """Dynamic shared memory of a backward block (``csrc/linear_scan_bwd.cu``'s
    ``scan_bwd_smem_bytes``): two buffer sets of five staged chunk-row
    arrays and five more (rows ``MAX_DIM + 4`` floats apart), the starting
    state and K, P and A (rows ``BWD_CHUNK + 4`` apart), three exchange
    arrays, 19 rows of ``MAX_DIM`` and two mbarriers."""
    c, d = BWD_CHUNK, MAX_DIM
    rs, ps = d + 4, c + 4
    return 4 * (15 * c * rs + 2 * d * rs + 2 * c * ps + 3 * c * d + 19 * d
                + 4)


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
                             readout_pre: bool = True):
    """The backward kernel's factoring in plain torch (f32).  A forward
    pass keeps each chunk's starting state; then the chunks, of
    ``BWD_CHUNK`` rows (padded with p = q = r = dy = 0 and a = 1), go in
    reverse with the carried cotangent K (the cotangent of the state after
    the chunk's last row).  Inside a chunk, two sub-chunks of ``BWD_SUB``
    rows: per-pair exponentials ``exp(Lr_u - L_s)`` only on the two
    diagonal sub-blocks; off them (u in sub-chunk 1, s in sub-chunk 0) each
    pair term factors as ``R~_u Q~_s`` with ``R~ = r exp(Lr - L_15)`` and
    ``Q~ = q exp(L_15 - L)``, every exponent <= 0.  dla sums the terms of
    ``a_t Σ_m G_t ⊙ S_{t-1}``, each of which carries a_t's factor: a
    diagonal block's straddling pairs per pair, the pairs across the two
    blocks as a prefix over sub-chunk 0's rows of q ⊙ (dq's off-block
    term) and a suffix over sub-chunk 1's of r ⊙ (dr's), so nothing
    cancels where the decays are strong.  Returns ``(dp, dq, dla, dr,
    ds0)`` (the CUDA source states the terms)."""
    pf, qf, af, rf, gy = (x.float() for x in (p, q, a, r, dy))
    BH, T, M = pf.shape
    N = qf.shape[-1]
    dev = pf.device
    C, B = BWD_CHUNK, BWD_SUB
    lo, hi = slice(0, B), slice(B, C)             # the two sub-chunks

    def pad(x, c0, fill):
        rows = min(C, T - c0)
        out = torch.full((BH, C, x.shape[-1]), fill, dtype=torch.float32,
                         device=dev)
        out[:, :rows] = x[:, c0:c0 + rows]
        return out

    S = (torch.zeros(BH, M, N, dtype=torch.float32, device=dev)
         if s0 is None else s0.float())
    c0s = list(range(0, T, C))
    starts = []
    for c0 in c0s:
        starts.append(S)
        L = torch.log(pad(af, c0, 1.0).clamp_min(TINY)).cumsum(1)
        S = S * torch.exp(L[:, -1])[:, None, :] + pad(pf, c0, 0.0) \
            .transpose(1, 2) @ (pad(qf, c0, 0.0) * torch.exp(L[:, -1:] - L))
    t = torch.arange(C, device=dev)
    sub = t // B
    rho = t - 1 if readout_pre else t             # the state row u reads
    vis = t[None, :] <= rho[:, None]              # (u, s)
    same = sub[:, None] == sub[None, :]
    before = t[None, :] < t[:, None]              # (t, s): s < t
    reads = rho[None, :] >= t[:, None]            # (t, u): rho(u) >= t
    strad = (reads[:, :, None] & before[:, None, :]
             & same[:, :, None] & same[:, None, :])   # (t, u, s), one block
    K = torch.zeros_like(S) if ds_fin is None else ds_fin.float()
    dp, dq, dla, dr = (torch.empty_like(x) for x in (pf, qf, af, rf))
    for ci in range(len(c0s) - 1, -1, -1):
        c0, S0 = c0s[ci], starts[ci]
        rows = min(C, T - c0)
        pc, qc, rc, yc = (pad(x, c0, 0.0) for x in (pf, qf, rf, gy))
        L = torch.log(pad(af, c0, 1.0).clamp_min(TINY)).cumsum(1)
        Lz = torch.cat([torch.zeros_like(L[:, :1]), L], 1)   # L_{-1} = 0
        Lr = Lz[:, :-1] if readout_pre else L
        L_end, l15 = L[:, -1:], L[:, B - 1:B]
        Qt = qc[:, lo] * torch.exp(l15 - L[:, lo])
        Rt = rc[:, hi] * torch.exp(Lr[:, hi] - l15)
        # the diagonal sub-blocks: per pair and channel
        diff = Lr[:, :, None, :] - L[:, None, :, :]          # (BH, u, s, N)
        E = torch.exp(torch.where((same & vis)[None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
        P = (yc @ pc.transpose(1, 2)) * vis
        A = torch.einsum("bun,bsn,busn->bus", rc, qc, E)
        drD = torch.einsum("bus,bsn,busn->bun", P, qc, E)
        dqD = torch.einsum("bus,bun,busn->bsn", P, rc, E)
        X = P[..., None] * rc[:, :, None, :] * qc[:, None, :, :] * E
        dlaD = torch.einsum("tus,busn->btn", strad.float(), X)
        # off them: R~ Q~ᵀ
        A[:, hi, lo] = Rt @ Qt.transpose(1, 2)
        drO, dqO = torch.zeros_like(rc), torch.zeros_like(qc)
        drO[:, hi] = torch.exp(Lr[:, hi] - l15) * (P[:, hi, lo] @ Qt)
        dqO[:, lo] = torch.exp(l15 - L[:, lo]) \
            * (P[:, hi, lo].transpose(1, 2) @ Rt)
        Eq = torch.exp(L_end - L)
        dp_c = A.transpose(1, 2) @ yc + (qc * Eq) @ K.transpose(1, 2)
        drS = torch.exp(Lr) * (yc @ S0)
        dqK = Eq * (pc @ K)
        DR, DQ = drS + drO, dqK + dqO
        # dla_t: the K ⊙ S_start term; the rows before t in t's sub-chunk
        # (K and off-block terms of dq) and in sub-chunk 0 for t in 1 (K
        # terms); the rows reading a state at or after t in t's sub-chunk
        # (S_start and off-block terms of dr) and in sub-chunk 1 for t in
        # 0 (S_start terms); the diagonal block's straddling pairs
        sub_t = sub[:, None]
        pre_in = (before & same).float()
        pre_out = (sub[None, :] < sub_t).float()
        suf_in = (reads & same).float()
        suf_out = (sub[None, :] > sub_t).float()
        dla_c = (torch.exp(L_end) * (K * S0).sum(1, keepdim=True)
                 + torch.einsum("ts,bsn->btn", pre_in, qc * DQ)
                 + torch.einsum("ts,bsn->btn", pre_out, qc * dqK)
                 + torch.einsum("tu,bun->btn", suf_in, rc * DR)
                 + torch.einsum("tu,bun->btn", suf_out, rc * drS)
                 + dlaD)
        out = slice(c0, c0 + rows)
        dp[:, out] = dp_c[:, :rows]
        dq[:, out] = (DQ + dqD)[:, :rows]
        dr[:, out] = (DR + drD)[:, :rows]
        dla[:, out] = dla_c[:, :rows]
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
    <= 64; one launch a call (``.launches``, ``.route_launches``): a block
    of ``BWD_THREADS`` a sequence, chunks of ``BWD_CHUNK`` rows factored in
    sub-chunks of ``BWD_SUB`` as :func:`linear_scan_bwd_emulated` shows,
    with a scratch of each chunk's starting state (64 x 64 floats a chunk).
    On CPU tensors: its plain version, :func:`linear_scan_bwd_plain_dla`."""
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
    states = torch.empty(BH, chunks, MAX_DIM, MAX_DIM, dtype=torch.float32,
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
