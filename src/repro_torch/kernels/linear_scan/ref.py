"""Plain PyTorch oracle for the unified linear-recurrence scan (the
reference's ``linear_scan_ref``, ``repro/kernels/linear_scan/ref.py``).

One recurrence covers both RWKV6 time-mix and Mamba2 SSD:

    S_t = S_{t-1} * a_t[None, :] + p_t ⊗ q_t          S: (M, N)
    y_t = (S_{t-1} if readout_pre else S_t) @ r_t      y: (M,)

* RWKV6:  M = head v-dim, N = head k-dim, a = data-dependent decay w_t,
          p = v_t, q = k_t, r = r_t, readout_pre=True.
* Mamba2: M = head dim, N = ssm state, a = exp(Δt·A) (broadcast over N),
          p = Δt·x_t, q = B_t, r = C_t, readout_pre=False.

The scan runs sequentially over T, batched over BH, in f32.  The CPU path
of the model stack and the tests use it; the card runs the kernel
(:mod:`.kernel`).  :func:`linear_scan_bwd_plain` is its gradient, the
reverse sequential scan: the tests hold it against autograd and the
reference's ``jax.vjp``, and ``chip_smoke.py`` holds the backward kernel
against it (nothing on the training path calls it).
"""

from __future__ import annotations

import torch

__all__ = ["linear_scan_ref", "linear_scan_bwd_plain"]


def linear_scan_ref(p, q, a, r, s0, *, readout_pre: bool = True):
    """p: (BH, T, M); q, a, r: (BH, T, N); s0: (BH, M, N).

    Returns (y: (BH, T, M) in p.dtype, s_final: (BH, M, N) f32).
    """
    pf, qf, af, rf = (x.float() for x in (p, q, a, r))
    s = s0.float()
    ys = []
    for t in range(pf.shape[1]):
        s_new = s * af[:, t, None, :] + pf[:, t, :, None] * qf[:, t, None, :]
        ys.append(torch.einsum("bmn,bn->bm", s if readout_pre else s_new,
                               rf[:, t]))
        s = s_new
    y = torch.stack(ys, dim=1) if ys else pf.new_zeros(pf.shape)
    return y.to(p.dtype), s


def linear_scan_bwd_plain(p, q, a, r, s0, dy, ds_fin=None, *,
                          readout_pre: bool = True):
    """The gradient of :func:`linear_scan_ref` by the reverse sequential
    scan: ``dy (BH, T, M)`` the cotangent of y and ``ds_fin (BH, M, N)``
    (or None) that of the final state; ``s0`` None means zeros.

    With ``G`` the cotangent of the state after row t (``ds_fin`` after the
    last row), going backward ``G <- G diag(a_t) + dy_t r_tᵀ`` (the readout
    term enters ``G`` before the decay under post-readout, after it under
    ``readout_pre``); ``dp_t = G q_t``, ``dq_t = Gᵀ p_t``, ``da_t = Σ_m G ⊙
    S_{t-1}`` (finite at any a: no division), ``dr_t`` the state read at row
    t times ``dy_t``, ``ds0`` the last ``G``.  Every state is kept from a
    forward pass.  Returns ``(dp, dq, da, dr, ds0)`` in f32."""
    pf, qf, af, rf, gy = (x.float() for x in (p, q, a, r, dy))
    BH, T, M = pf.shape
    N = qf.shape[-1]
    s = (torch.zeros(BH, M, N, dtype=torch.float32, device=pf.device)
         if s0 is None else s0.float())
    states = [s]
    for t in range(T):
        s = s * af[:, t, None, :] + pf[:, t, :, None] * qf[:, t, None, :]
        states.append(s)
    G = (torch.zeros_like(s) if ds_fin is None else ds_fin.float().clone())
    dp, dq, da, dr = (torch.empty_like(x) for x in (pf, qf, af, rf))
    for t in range(T - 1, -1, -1):
        read = states[t] if readout_pre else states[t + 1]
        dr[:, t] = torch.einsum("bmn,bm->bn", read, gy[:, t])
        if not readout_pre:
            G = G + gy[:, t, :, None] * rf[:, t, None, :]
        dp[:, t] = torch.einsum("bmn,bn->bm", G, qf[:, t])
        dq[:, t] = torch.einsum("bmn,bm->bn", G, pf[:, t])
        da[:, t] = (G * states[t]).sum(1)
        G = G * af[:, t, None, :]
        if readout_pre:
            G = G + gy[:, t, :, None] * rf[:, t, None, :]
    return dp, dq, da, dr, G
