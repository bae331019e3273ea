"""Online-softmax partial states and the merge monoid of ring attention.

A flash pass over one K/V *stripe* gives a partial-softmax state
``(m, l, acc)``: row max, normalizer and unnormalized value sum.  Ring
attention never sees the stripes in one scan: each rank folds the states of
the stripes the bidirectional ring delivers, in schedule order, with
:func:`merge_states`.

* The merge is associative and, up to float rounding, order-free.
* The masked-empty state ``(m = -inf, l = 0, acc = 0)`` is the EXACT
  identity of the merge: an empty side is told by its ``-inf`` max and the
  other side passes through verbatim.  So a stripe wholly in a rank's
  causal future may be skipped without changing a bit of the fold.

The plain version, :func:`~.ref.ring_attention_ref`, the serialized host
listing and the fused emulation (:mod:`.fused`) all fold with these
functions in one schedule order, so equal inputs give equal bits.  The
reference gets that contract by routing each piece through numpy host
callbacks; here the pieces are eager torch, and every step whose bits could
depend on how a call batches its rows (the BLAS products, the row sums, the
exponentials, whose vector and scalar tails round differently) runs in
float64 and rounds its result to float32 once.  Everything else is
elementwise float32 arithmetic, which rounds the same wherever it runs.

Shapes (f32; GQA grouped like the flash kernel; any leading dims ``...``):
``m, l: (..., Tq, KH, G)``; ``acc: (..., Tq, KH, G, Dv)``.  The VJP pieces
of the reference (``chain_grads`` and the ``*_bwd`` functions) belong to
training and are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "scaled_queries",
    "empty_state",
    "stripe_mask",
    "stripe_state",
    "merge_states",
    "finalize_state",
]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_NEG_INF = float("-inf")


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` computed in float64 and rounded once (see module doc)."""
    return torch.exp(x.double()).float()


def scaled_queries(q: torch.Tensor, kh: int, scale: float) -> torch.Tensor:
    """``(..., Tq, H, D)`` queries -> pre-scaled f32 ``(..., Tq, KH, G, D)``."""
    H, D = q.shape[-2:]
    if H % kh:
        raise ValueError(f"H={H} not divisible by kv heads {kh}")
    return (q.float() * scale).reshape(*q.shape[:-2], kh, H // kh, D)


def empty_state(qg: torch.Tensor, dv: int) -> State:
    """The merge identity: no keys seen yet (``m = -inf, l = 0, acc = 0``)."""
    lead = qg.shape[:-1]
    return (torch.full(lead, _NEG_INF, dtype=torch.float32, device=qg.device),
            torch.zeros(lead, dtype=torch.float32, device=qg.device),
            torch.zeros(*lead, dv, dtype=torch.float32, device=qg.device))


def stripe_mask(S: int, *, q_pos: torch.Tensor, k_start, causal: bool,
                valid_len=None) -> torch.Tensor:
    """Visibility of one stripe's ``S`` key rows to the query positions
    ``q_pos (..., Tq)``: ``(..., Tq, S)`` boolean.  ``k_start`` (the
    stripe's first global key) and ``valid_len`` are ints or tensors that
    broadcast against ``q_pos``'s leading dims."""
    dev = q_pos.device
    lead = q_pos.shape[:-1]

    def col(x):                                   # (..., 1, 1)
        return torch.as_tensor(x, device=dev)[..., None, None]

    k_pos = col(k_start) + torch.arange(S, device=dev)
    vis = torch.ones((*lead, 1, S), dtype=torch.bool, device=dev)
    if valid_len is not None:
        vis = vis & (k_pos < col(valid_len))
    if causal:
        vis = vis & (k_pos <= q_pos[..., None])
    return vis.expand(torch.broadcast_shapes(vis.shape,
                                             (*lead, q_pos.shape[-1], S)))


def stripe_state(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 vis: torch.Tensor) -> State:
    """Partial-softmax state of the queries ``qg (..., Tq, KH, G, D)``
    against one stripe ``k (..., S, KH, D)``, ``v (..., S, KH, Dv)`` under
    the visibility ``vis (..., Tq, S)``.  A fully masked stripe returns
    exactly :func:`empty_state`'s values."""
    s = torch.einsum("...qhgd,...khd->...qhgk", qg.double(),
                     k.double()).float()
    see = vis[..., :, None, None, :]
    s = torch.where(see, s, _NEG_INF)
    m = s.amax(dim=-1)                            # -inf on fully masked rows
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(see, _exp(s - m_safe[..., None]), 0.0)
    l = p.double().sum(dim=-1).float()
    acc = torch.einsum("...qhgk,...khd->...qhgd", p.double(),
                       v.double()).float()
    return m, l, acc


def merge_states(a: State, b: State) -> State:
    """Combine two partial-softmax states (associative; identity =
    :func:`empty_state`).  Each side is rescaled from its own max to the
    joint max; a ``-inf`` side is empty and the other passes through
    verbatim (``-0.0`` included)."""
    m1, l1, a1 = a
    m2, l2, a2 = b
    empty1, empty2 = torch.isneginf(m1), torch.isneginf(m2)
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    e1 = _exp(m1 - m_safe)                        # -inf max -> 0
    e2 = _exp(m2 - m_safe)
    l = torch.where(empty2, l1, torch.where(empty1, l2, l1 * e1 + l2 * e2))
    acc = torch.where(empty2[..., None], a1,
                      torch.where(empty1[..., None], a2,
                                  a1 * e1[..., None] + a2 * e2[..., None]))
    return m, l, acc


def finalize_state(state: State, dtype) -> torch.Tensor:
    """Normalize the folded state to the ``(..., Tq, H, Dv)`` output; rows
    that saw no key (``l == 0``) come out as zeros."""
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(*out.shape[:-3], -1, out.shape[-1]).to(dtype)
