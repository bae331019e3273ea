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
(:mod:`.kernel`).
"""

from __future__ import annotations

import torch

__all__ = ["linear_scan_ref"]


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
