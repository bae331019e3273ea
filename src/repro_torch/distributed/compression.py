"""Gradient compression with error feedback, on stacked ranks.

The reference's codecs (``repro/distributed/compression.py``): symmetric
int8 quantization with a per-tensor or per-block scale, the two-phase int8
all-reduce (all-to-all of the int8 chunks, a local reduce in the
dequantized domain, the reduced shard re-quantized and all-gathered) with
the quantization residual carried to the next step, and top-k
sparsification with error feedback.  They are not in the DiOMP paper; the
reference adds them for the inter-pod all-reduce at scale.

Tensors are stacked: ``x (*mesh, ...)`` holds every rank's payload, and
each collective phase is a flat backend verb over the group's rank dims.
The reference runs these phases as raw ``lax`` collectives, not through a
communicator handle, so they record nothing on the OMPCCL logs; neither
do they here.  :func:`quantize_int8` takes ``lead`` leading dims that each
get their own scales (``lead=0`` is the reference's call on one rank).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.backends import XlaBackend, group_rank, group_size
from ..core.groups import DiompGroup
from ..launch.mesh import RankMesh

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "compressed_allreduce",
    "topk_compress",
    "topk_allreduce",
    "wire_bytes",
]

_WIRE = XlaBackend()


def quantize_int8(x: torch.Tensor, *, block: Optional[int] = None,
                  lead: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: ``q = round(x / scale)``, ``scale = amax / 127``
    (1 where amax is 0), clipped to [-127, 127].

    ``block=None``: one scale over the dims past the ``lead`` leading
    ones, shaped ``x.shape[:lead]``.  With ``block``, the dims past
    ``lead`` hold ``n * block`` elements and each run of ``block`` gets its
    own scale, shaped ``(*x.shape[:lead], n)``."""
    lead_shape = x.shape[:lead]
    xf = x.float()
    if block is None:
        amax = xf.reshape(*lead_shape, -1).abs().amax(-1)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        s = scale.reshape(*lead_shape, *([1] * (x.dim() - lead)))
        q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        return q, scale
    blocks = xf.reshape(*lead_shape, -1, block)
    amax = blocks.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127
                    ).to(torch.int8).reshape(x.shape)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, *,
                    block: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (f32); ``scale``'s dims are the
    leading dims of ``q`` that own scales (plus the block dim)."""
    lead = scale.dim() - (1 if block else 0)
    if block is None:
        s = scale.reshape(*scale.shape, *([1] * (q.dim() - lead)))
        return q.float() * s
    return (q.reshape(*q.shape[:lead], -1, block).float()
            * scale[..., None]).reshape(q.shape)


def compressed_allreduce(x: torch.Tensor, group: DiompGroup, mesh: RankMesh,
                         *, error: Optional[torch.Tensor] = None,
                         block: Optional[int] = None):
    """int8 all-reduce with error feedback (ZeRO++ qgZ-style, two phases).

    ``x (*mesh, ...)``.  Phase 1: every rank quantizes its payload, the
    int8 chunks go all-to-all and the scales are all-gathered; each rank
    dequantizes what it received with the source's scales and sums (its
    shard of the mean).  Phase 2: the shard is quantized again and
    all-gathered.  Returns ``(mean, new_error)``, both shaped like ``x``:
    the group mean on every rank, and the first quantization's residual
    (``x + error`` minus its int8 image).  ``block`` selects per-block
    scales; a payload that ``n * block`` (``n`` without a block) does not
    divide is zero-padded on the way in and cut on the way out."""
    if error is not None:
        x = x + error
    nd = mesh.ndim
    n = group_size(group, mesh)
    lead = x.shape[:nd]
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.float().reshape(*lead, -1)
    size = flat.shape[-1]
    pad = (-size) % (n * block if block else n)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(*lead, pad)], dim=-1)

    q, scale = quantize_int8(flat, block=block, lead=nd)
    # phase 1: chunk i of my int8 payload to rank i; the scales to everyone
    chunks = q.reshape(*lead, n, -1)
    recv = _WIRE.alltoall(chunks, group, mesh, split_axis=0, concat_axis=0)
    scales = scale if block else scale.reshape(*lead, 1)
    scales = _WIRE.allgather(scales, group, mesh, axis=0)   # (*mesh, n·nb)
    if block:
        # the (n, nb) source-major scale table; my chunk spans blocks
        # [rank·bc, (rank + 1)·bc) of every source's payload
        bc = chunks.shape[-1] // block
        table = scales.reshape(*lead, n, -1, bc)
        me = group_rank(group, mesh, x.device).reshape(*lead, 1, 1, 1)
        mine = torch.gather(table, -2, me.expand(*lead, n, 1, bc))
        shard = (recv.reshape(*lead, n, bc, block).float()
                 * mine.reshape(*lead, n, bc, 1)).sum(nd).reshape(*lead, -1)
    else:
        shard = (recv.float() * scales[..., None]).sum(nd)
    shard = shard / n

    # phase 2: the re-quantized shard all-gathered (every rank the same)
    q2, s2 = quantize_int8(shard, block=block, lead=nd)
    gathered = _WIRE.allgather(q2, group, mesh, axis=0)
    s2_all = _WIRE.allgather(s2 if block else s2.reshape(*lead, 1), group,
                             mesh, axis=0)
    if block:
        out = dequantize_int8(gathered, s2_all, block=block)
    else:
        out = (gathered.reshape(*lead, n, -1).float()
               * s2_all[..., None]).reshape(*lead, -1)
    deq = dequantize_int8(q, scale, block=block)
    if pad:
        out, flat, deq = out[..., :size], flat[..., :size], deq[..., :size]
    new_error = flat - deq
    return (out.reshape(orig_shape).to(orig_dtype),
            new_error.reshape(orig_shape).to(orig_dtype))


def topk_compress(x: torch.Tensor, k: int):
    """The ``k`` largest-|x| entries of one rank's flattened tensor:
    ``(values, indices)``."""
    flat = x.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_allreduce(x: torch.Tensor, group: DiompGroup, mesh: RankMesh, *,
                   k: int, error: Optional[torch.Tensor] = None):
    """Top-k sparsified group mean with error feedback, each rank keeping
    its own ``k`` entries.  Returns ``(mean, new_error)``."""
    if error is not None:
        x = x + error
    nd = mesh.ndim
    lead = x.shape[:nd]
    flat = x.reshape(-1, x[(0,) * nd].numel())
    _, idx = torch.topk(flat.abs(), k, dim=-1)
    sparse = torch.zeros_like(flat).scatter(-1, idx, flat.gather(-1, idx))
    sparse = sparse.reshape(*lead, -1)
    reduced = _WIRE.allreduce(sparse, group, mesh) / group_size(group, mesh)
    new_error = flat.reshape(*lead, -1) - sparse
    return reduced.reshape(x.shape), new_error.reshape(x.shape)


def wire_bytes(numel: int, *, codec: str, k: int = 0,
               block: Optional[int] = None) -> int:
    """Bytes on the wire per rank for one reduce (roofline accounting)."""
    if codec == "f32":
        return 4 * numel
    if codec == "bf16":
        return 2 * numel
    if codec == "int8":
        if block:
            return numel + 4 * (-(-numel // block))  # payload + block scales
        return numel + 4  # payload + scale
    if codec == "topk":
        return 8 * k      # (f32 value + i32 index) per kept entry
    raise ValueError(codec)
