"""The chunked linear-scan kernel (``csrc/linear_scan.cu``) and its wrapper.

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
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import check_launch, library, stream_handle
from ..plan import SCAN_CHUNK, SCAN_ROUTES, SCAN_SUB, scan_instance, scan_route
from .ref import linear_scan_ref

__all__ = ["linear_scan_kernel", "linear_scan_plain", "linear_scan_emulated",
           "MAX_CHUNK", "MAX_DIM"]

MAX_CHUNK = 64   # rows of a chunk the kernel stages
MAX_DIM = 64     # largest M and N it takes


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
