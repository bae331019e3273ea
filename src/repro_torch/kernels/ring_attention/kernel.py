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
``m, l: (..., Tq, KH, G)``; ``acc: (..., Tq, KH, G, Dv)``.

The gradient
------------
Autodiff through the ring would sum each K/V shard's cotangent in an order
that depends on how the ring is executed, so every execution (the plain
version, the host listing, the fused emulation) differentiates the whole
schedule by hand with :func:`chain_grads` and sums a shard's contributions
in ONE canonical order: the owner's own stripe, then the clockwise
deliveries by ascending step, then the counter-clockwise ones.  The pieces
keep the forward's rule (float64 products, row sums and exponentials,
rounded once; elementwise float32 else), so the executions' gradients are
equal bit for bit too.  The finalized output does not depend on any ``m``
(the normalizer cancels between ``l`` and ``acc``), so every ``m``
cotangent is exactly zero and the rest are the plain softmax and rescale
pullbacks.  :func:`custom_vjp` installs such a backward on a function.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

__all__ = [
    "scaled_queries",
    "empty_state",
    "stripe_mask",
    "stripe_state",
    "merge_states",
    "finalize_state",
    "finalize_bwd",
    "merge_bwd",
    "stripe_bwd",
    "chain_grads",
    "custom_vjp",
]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_NEG_INF = float("-inf")


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` computed in float64 and rounded once (see module doc)."""
    return torch.exp(x.double()).float()


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """An f32 product computed in float64 and rounded once."""
    return torch.einsum(eq, *(t.double() for t in ops)).float()


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


def _stripe_p(qg: torch.Tensor, k: torch.Tensor, vis: torch.Tensor):
    """Softmax numerator ``p`` (0 where masked) and row max ``m`` of one
    stripe."""
    s = _einsum("...qhgd,...khd->...qhgk", qg, k)
    see = vis[..., :, None, None, :]
    s = torch.where(see, s, _NEG_INF)
    m = s.amax(dim=-1)                            # -inf on fully masked rows
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    return torch.where(see, _exp(s - m_safe[..., None]), 0.0), m


def stripe_state(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 vis: torch.Tensor) -> State:
    """Partial-softmax state of the queries ``qg (..., Tq, KH, G, D)``
    against one stripe ``k (..., S, KH, D)``, ``v (..., S, KH, Dv)`` under
    the visibility ``vis (..., Tq, S)``.  A fully masked stripe returns
    exactly :func:`empty_state`'s values."""
    p, m = _stripe_p(qg, k, vis)
    l = p.double().sum(dim=-1).float()
    return m, l, _einsum("...qhgk,...khd->...qhgd", p, v)


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


# -- the hand-written VJP of a fold chain -------------------------------------


def finalize_bwd(ct: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """Cotangents ``(gl, gacc)`` of :func:`finalize_state`'s normalize for
    the output cotangent ``ct (..., Tq, KH, G, Dv)`` f32; ``gl`` is 0 on
    rows that saw no key (``l < 1e-30``)."""
    L = torch.clamp(l, min=1e-30)
    gacc = ct / L[..., None]
    rowsum = (ct.double() * acc.double()).sum(dim=-1).float()
    gl = torch.where(l >= 1e-30, -rowsum / (L * L), 0.0)
    return gl, gacc


def merge_bwd(m1: torch.Tensor, m2: torch.Tensor, gl: torch.Tensor,
              gacc: torch.Tensor):
    """Cotangents ``(gl1, gl2, gacc1, gacc2)`` of one merge, from the two
    sides' row maxes; an empty side of the merge passed the other through
    verbatim, so the other's cotangent passes through verbatim too."""
    empty1, empty2 = torch.isneginf(m1), torch.isneginf(m2)
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    e1 = _exp(m1 - m_safe)
    e2 = _exp(m2 - m_safe)
    c1 = torch.where(empty2, 1.0, torch.where(empty1, 0.0, e1))
    c2 = torch.where(empty2, 0.0, torch.where(empty1, 1.0, e2))
    return gl * c1, gl * c2, gacc * c1[..., None], gacc * c2[..., None]


def stripe_bwd(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               vis: torch.Tensor, gl: torch.Tensor, gacc: torch.Tensor):
    """Cotangents ``(gqg, gk, gv)`` (f32) of one :func:`stripe_state` from
    those of its ``l`` and ``acc``: ``ds = p (gl + gacc v^T)``, 0 where
    masked."""
    p, _ = _stripe_p(qg, k, vis)
    ds = p * (gl[..., None] + _einsum("...qhgd,...khd->...qhgk", gacc, v))
    return (_einsum("...qhgk,...khd->...qhgd", ds, k),
            _einsum("...qhgk,...qhgd->...khd", ds, qg),
            _einsum("...qhgk,...qhgd->...khd", p, gacc))


def chain_grads(qg: torch.Tensor, stripes: Sequence, ct: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
    """Backward of ``finalize(fold(empty, stripes))`` for the queries
    ``qg``: ``stripes`` the fold-order ``(k, v, vis)`` and ``ct (..., Tq,
    KH, G, Dv)`` the f32 output cotangent.  Recomputes the forward chain,
    walks the merges in reverse and returns ``(gqg, [gk_i], [gv_i])``: the
    query cotangent summed over the stripes in fold order and each stripe's
    K/V cotangents (f32, fold order), for the caller to route to the
    stripes' owners and sum canonically."""
    state = empty_state(qg, stripes[0][1].shape[-1])
    states, blocks = [], []
    for k, v, vis in stripes:
        blk = stripe_state(qg, k, v, vis)
        states.append(state)
        blocks.append(blk)
        state = merge_states(state, blk)
    gl, gacc = finalize_bwd(ct, state[1], state[2])
    per_stripe = [None] * len(stripes)
    for i in reversed(range(len(stripes))):
        gl1, gl2, ga1, ga2 = merge_bwd(states[i][0], blocks[i][0], gl, gacc)
        per_stripe[i] = (gl2, ga2)
        gl, gacc = gl1, ga1                  # the empty state's dies at i=0
    gqg, gks, gvs = None, [], []
    for (k, v, vis), (gl_i, ga_i) in zip(stripes, per_stripe):
        gq_i, gk_i, gv_i = stripe_bwd(qg, k, v, vis, gl_i, ga_i)
        gqg = gq_i if gqg is None else gqg + gq_i
        gks.append(gk_i)
        gvs.append(gv_i)
    return gqg, gks, gvs


class _CustomVjp(torch.autograd.Function):
    @staticmethod
    def forward(fctx, run, grads, *args):
        fctx.save_for_backward(*args)
        fctx.grads = grads
        return run(*args)

    @staticmethod
    def backward(fctx, ct):
        return (None, None, *fctx.grads(*fctx.saved_tensors, ct))


def custom_vjp(run: Callable, grads: Callable, *args: torch.Tensor):
    """``run(*args)`` whose backward is ``grads(*args, ct)`` (one cotangent
    an argument), not autograd through ``run``: the port's
    ``jax.custom_vjp``."""
    return _CustomVjp.apply(run, grads, *args)
