"""Plain PyTorch flash attention with GQA — the reference's blockwise oracle
(``repro/kernels/flash_attention/ref.py``) term for term.

KV is consumed in blocks with an online softmax (f32 running max,
denominator and accumulator), so the full (Tq, Tk) score matrix never
exists.  Supports GQA, causal masking with a query position offset and a
bidirectional prefix window, a valid KV length, and ``Dv != D``.
``q_offset`` and ``valid_len`` may be ints or (B,) tensors (per-slot decode
positions).  The CPU path of the model stack and the tests use it; the card
runs the kernel (:mod:`.kernel`).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref"]


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
                        block: int = 512, valid_len=None) -> torch.Tensor:
    """q (B, Tq, H, D), k (B, Tk, KH, D), v (B, Tk, KH, Dv) -> (B, Tq, H, Dv)."""
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
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).reshape(B, Tq, H, Dv).to(q.dtype)
