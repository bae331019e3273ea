"""Plain PyTorch flash attention with GQA — the reference's blockwise oracle
(``repro/kernels/flash_attention/ref.py``) term for term.

KV is consumed in blocks with an online softmax (f32 running max,
denominator and accumulator), so the full (Tq, Tk) score matrix never
exists.  Supports GQA, causal masking with a query position offset and a
bidirectional prefix window, a valid KV length, and ``Dv != D``.
``q_offset`` and ``valid_len`` may be ints or (B,) tensors (per-slot decode
positions).  The CPU path of the model stack and the tests use it; the card
runs the kernel (:mod:`.kernel`).  :func:`flash_attention_bwd_ref` is the
gradient's plain version, by the backward kernel's formulas.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "visible_keys"]


def _block_update(carry, k_blk, v_blk, q, *, causal, q_offset, prefix_len,
                  start, valid_len):
    """Online-softmax update for one KV block starting at key ``start``."""
    m_prev, l_prev, acc_prev = carry
    B, Tq, KH, G, D = q.shape
    block = k_blk.shape[1]
    s = torch.einsum("bqhgd,bkhd->bqhgk", q, k_blk.float())

    k_pos = start + torch.arange(block, device=q.device)
    q_pos = q_offset.reshape(-1, 1, 1) \
        + torch.arange(Tq, device=q.device).reshape(1, -1, 1)
    kp = k_pos.reshape(1, 1, -1)
    vis = kp < valid_len.reshape(-1, 1, 1)
    if causal:
        # bidirectional inside the prefix window, causal after it
        vis = vis & ((kp <= q_pos) | ((kp < prefix_len) & (q_pos < prefix_len)))
    vis = vis.expand(B, Tq, block)[:, :, None, None, :]
    s = torch.where(vis, s, float("-inf"))

    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # guard: fully-masked rows keep m = -inf; use a safe subtrahend there
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(vis, p, 0.0)
    scale = torch.where(torch.isneginf(m_prev), 0.0,
                        torch.exp(m_prev - m_safe))
    l_new = l_prev * scale + p.sum(dim=-1)
    acc_new = acc_prev * scale[..., None] + torch.einsum(
        "bqhgk,bkhd->bqhgd", p, v_blk.float())
    return m_new, l_new, acc_new


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset=0,
                        prefix_len: int = 0, scale: Optional[float] = None,
                        block: int = 512, valid_len=None,
                        return_lse: bool = False):
    """q (B, Tq, H, D), k (B, Tk, KH, D), v (B, Tk, KH, Dv) -> (B, Tq, H, Dv);
    with ``return_lse`` also each row's log-sum-exp of the scaled scores
    ``(B, Tq, H)`` f32 (+inf for a row that sees no key), which the
    backward recomputes the probabilities from."""
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    assert H % KH == 0, (H, KH)
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    if valid_len is None:
        valid_len = Tk
    block = min(block, Tk)
    dev = q.device
    q_offset = torch.as_tensor(q_offset, device=dev)
    valid_len = torch.as_tensor(valid_len, device=dev)

    qg = (q.float() * scale).reshape(B, Tq, KH, G, D)
    m = torch.full((B, Tq, KH, G), float("-inf"), device=dev)
    l = torch.zeros((B, Tq, KH, G), device=dev)
    acc = torch.zeros((B, Tq, KH, G, Dv), device=dev)
    for start in range(0, Tk, block):
        k_blk, v_blk = k[:, start:start + block], v[:, start:start + block]
        pad = block - k_blk.shape[1]
        if pad:                 # the reference pads the last block with zeros
            k_blk = torch.cat([k_blk, k_blk.new_zeros(B, pad, KH, D)], 1)
            v_blk = torch.cat([v_blk, v_blk.new_zeros(B, pad, KH, Dv)], 1)
        m, l, acc = _block_update(
            (m, l, acc), k_blk, v_blk, qg, causal=causal, q_offset=q_offset,
            prefix_len=prefix_len, start=start, valid_len=valid_len)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(
        B, Tq, H, Dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), float("inf"))
    return out, lse.reshape(B, Tq, H)


def visible_keys(Tq: int, Tk: int, *, causal: bool, q_offset, prefix_len: int,
                 valid_len, device) -> torch.Tensor:
    """The forward's mask ``(B|1, Tq, Tk)``: key k visible to query row t
    (position ``q_offset + t``)."""
    q_offset = torch.as_tensor(q_offset, device=device).reshape(-1, 1, 1)
    valid_len = torch.as_tensor(valid_len, device=device).reshape(-1, 1, 1)
    q_pos = q_offset + torch.arange(Tq, device=device).reshape(1, -1, 1)
    kp = torch.arange(Tk, device=device).reshape(1, 1, -1)
    vis = kp < valid_len
    if causal:
        vis = vis & ((kp <= q_pos)
                     | ((kp < prefix_len) & (q_pos < prefix_len)))
    return vis


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            q_offset=0, prefix_len: int = 0,
                            scale: Optional[float] = None, valid_len=None):
    """The gradient of :func:`flash_attention_ref` in plain torch, by the
    formulas the backward kernel (``csrc/flash_attention_bwd.cu``) runs, in
    f32: ``P = exp(scale q k^T - lse)`` (0 where masked), ``dv = P^T dO``,
    ``dP = dO v^T``, ``dS = P (dP - rowsum(dO O))``, ``dq = scale dS k``,
    ``dk = scale dS^T q``.  q (B, Tq, H, D), k (B, Tk, KH, D), v (B, Tk, KH,
    Dv), o and do (B, Tq, H, Dv), lse (B, Tq, H); returns (dq, dk, dv) in
    the inputs' dtypes.  The whole (Tq, Tk) score matrix is formed: a test
    and card-check oracle, not a path of the model stack on the card."""
    B, Tq, H, D = q.shape
    Tk, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    if valid_len is None:
        valid_len = Tk
    vis = visible_keys(Tq, Tk, causal=causal, q_offset=q_offset,
                       prefix_len=prefix_len, valid_len=valid_len,
                       device=q.device)[:, :, None, None, :]
    qs = (q.float() * scale).reshape(B, Tq, KH, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Tq, KH, G, Dv)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kf)
    p = torch.where(vis, torch.exp(s - lse.float().reshape(
        B, Tq, KH, G)[..., None]), 0.0)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
    delta = (dof * o.float().reshape(B, Tq, KH, G, Dv)).sum(-1)
    ds = torch.where(vis, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qs)
    return (dq.reshape(B, Tq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
