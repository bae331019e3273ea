"""The flash-attention kernel (``csrc/flash_attention.cu``) and its wrapper.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention/
kernel.py:80``, ``pallas_call`` at :125).  What bounds it on the H100 and
what its design does about that is noted in the CUDA source.  On CPU tensors
the wrapper computes the plain version, :func:`.ref.flash_attention_ref`.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .._build import DTYPE_CODES, check_launch, library, stream_handle
from ..plan import default_planner
from .ref import flash_attention_ref

__all__ = ["flash_attention_kernel", "flash_attention_plain"]

Offsets = Union[int, torch.Tensor]


def _per_row(x: Offsets, lead, device) -> torch.Tensor:
    """An int or a tensor broadcast to the leading (batch) dims, as int32."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(lead)


def _key_tile(q, k, v, block: Optional[int]) -> int:
    """The key tile the kernel stages: the planner's, at most ``block``."""
    return default_planner().plan_attention_block(
        q.shape[-3], k.shape[-3], q.shape[-1], v.shape[-1], q.dtype,
        block=512 if block is None else block)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: Offsets = 0, prefix_len: int = 0,
                          scale: Optional[float] = None,
                          block: Optional[int] = None,
                          valid_len: Optional[Offsets] = None) -> torch.Tensor:
    """The plain version over any leading dims: ``q (..., Tq, H, D)``,
    ``k (..., Tk, KH, D)``, ``v (..., Tk, KH, Dv)``; the offsets broadcast
    to the leading dims.  It folds the kernel's key tile per update."""
    lead = q.shape[:-3]
    block = _key_tile(q, k, v, block)
    if valid_len is None:
        valid_len = k.shape[-3]
    out = flash_attention_ref(
        q.reshape(-1, *q.shape[-3:]), k.reshape(-1, *k.shape[-3:]),
        v.reshape(-1, *v.shape[-3:]), causal=causal,
        q_offset=_per_row(q_offset, lead, q.device).reshape(-1),
        prefix_len=prefix_len, scale=scale, block=block,
        valid_len=_per_row(valid_len, lead, q.device).reshape(-1))
    return out.reshape(*lead, *out.shape[-3:])


def _rank_batch(t: torch.Tensor, what: str):
    """``t (..., B, T, H, D)`` as (R, B, T, H, D) strides without a copy:
    every dim before B is folded into R."""
    if t.stride(-1) != 1:
        raise ValueError(f"flash attention: {what} needs a unit last stride")
    lead = t.shape[:-4]
    try:
        r = t.view(-1, *t.shape[-4:]) if lead else t.unsqueeze(0)
    except RuntimeError:
        raise ValueError(
            f"flash attention: {what} of shape {tuple(t.shape)} and strides "
            f"{t.stride()} cannot fold its rank dims without a copy") from None
    return r.stride()[:4]


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           q_offset: Offsets = 0, prefix_len: int = 0,
                           scale: Optional[float] = None,
                           block: Optional[int] = None,
                           valid_len: Optional[Offsets] = None
                           ) -> torch.Tensor:
    """GQA flash attention: ``q (..., B, Tq, H, D)``, ``k (..., B, Tk, KH,
    D)``, ``v (..., B, Tk, KH, Dv)`` -> ``(..., B, Tq, H, Dv)``.

    The leading dims (ranks, then the batch) must agree; each operand may be
    a strided view (a layer of a stacked cache).  ``q_offset`` and
    ``valid_len`` are ints or int tensors that broadcast to the leading
    dims; on the card they stay there (per-slot decode positions are never
    read back).  ``valid_len`` must not exceed Tk.  The key tile is the
    planner's ``plan_attention_block`` at most ``block``.  On the card q, k
    and v must share one dtype.
    """
    lead = q.shape[:-3]
    Tq, H, D = q.shape[-3:]
    Tk, KH, Dk = k.shape[-3:]
    Dv = v.shape[-1]
    if k.shape[:-3] != lead or v.shape[:-1] != k.shape[:-1] or Dk != D \
            or H % KH:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, prefix_len=prefix_len,
                                     scale=scale, block=block,
                                     valid_len=valid_len)
    if q.dtype not in DTYPE_CODES or not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"flash attention kernel takes one of f32/f16/bf16 "
                        f"for q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash attention: q, k and v on different devices")
    if len(lead) < 1:
        raise ValueError("flash attention needs a batch dim")
    out = torch.empty(*lead, Tq, H, Dv, dtype=q.dtype, device=q.device)
    if min(Tq, Tk, H) == 0:
        return out.zero_()
    B = lead[-1]
    R = math.prod(lead) // B
    if valid_len is None:
        valid_len = Tk
    qo = _per_row(q_offset, lead, q.device).contiguous()
    vl = _per_row(valid_len, lead, q.device).contiguous()
    tile = _key_tile(q, k, v, block)
    qs, ks, vs, os_ = (_rank_batch(t, n) for t, n in
                       ((q, "q"), (k, "k"), (v, "v"), (out, "out")))
    status = library("flash_attention").repro_flash_attention(
        q.data_ptr(), *qs, k.data_ptr(), *ks, v.data_ptr(), *vs,
        out.data_ptr(), *os_, qo.data_ptr(), vl.data_ptr(),
        R, B, Tq, Tk, H, KH, D, Dv, tile, int(causal), int(prefix_len),
        float(D ** -0.5 if scale is None else scale), DTYPE_CODES[q.dtype],
        stream_handle(q.device))
    flash_attention_kernel.launches += 1
    check_launch(status, "flash attention")
    return out


flash_attention_kernel.launches = 0
