"""Optimizers on stacked local parameter shards.

The reference's ``repro/train/optim.py``: AdamW for the small archs and
Adafactor (factored second moment, no momentum) for the large ones, a
cosine schedule, and the global-norm helpers.  Every parameter enters the
step as a stacked tensor ``(*mesh, *local)``, so the optimizer state
takes the same layout and sharding (ZeRO-1 falls out of the placement).
AdamW is elementwise and runs on the stacked tensors as they are;
Adafactor's row/column statistics are means over full dims, so a sharded
dim reduces through an explicit OMPCCL mean, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

__all__ = ["adamw", "adafactor", "adafactor_dim_axes", "cosine_schedule",
           "Optimizer", "global_norm", "clip_by_global_norm",
           "bucketed_sq_norm"]

F32 = torch.float32


def _local_dims(t: torch.Tensor, nd: int) -> Tuple[int, ...]:
    return tuple(range(nd, t.dim()))


def bucketed_sq_norm(bufs: Dict[str, torch.Tensor], plan,
                     nd: int) -> torch.Tensor:
    """Per-rank sum of squares of reduced flat buckets ``(*mesh, n)``, each
    weighted by 1/duplication (replicated copies count once); the caller
    owns the world all-reduce and the square root."""
    total = None
    for b in plan.buckets:
        buf = bufs[b.key]
        part = buf.float().pow(2).sum(_local_dims(buf, nd)) / b.dup
        total = part if total is None else total + part
    return total


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, step, inplace=False)`` returns
    ``(updates, new_state)``; with ``inplace`` the new state is written
    into the old state's tensors (the step's donated buffers), which saves
    one copy of the state at the peak."""

    init: Callable           # params -> opt_state
    update: Callable         # (grads, state, params, step) -> (updates, state)
    state_structs: Callable  # param shapes -> state shapes


def _put(old: torch.Tensor, new: torch.Tensor, inplace: bool) -> torch.Tensor:
    """``new``, written into ``old``'s storage when ``inplace``."""
    return old.copy_(new) if inplace else new


def cosine_schedule(peak_lr: float, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` of it
    (the reference's schedule, in f32)."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a (nested) dict of tensors, in f32."""
    leaves = list(_leaves(tree))
    return torch.sqrt(sum(l.float().pow(2).sum() for l in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with f32 moments; ``update`` returns the updates in each
    parameter's dtype, as the reference's does."""
    def init(params):
        return {"m": {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for n, p in params.items()},
                "v": {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for n, p in params.items()}}

    def update(grads, state, params, step, inplace: bool = False):
        t = float(step) + 1.0
        lr = lr_fn(step)
        # the bias corrections in f32, as jnp computes b ** t on f32 t
        c1 = 1 - torch.tensor(b1, dtype=F32) ** torch.tensor(t, dtype=F32)
        c2 = 1 - torch.tensor(b2, dtype=F32) ** torch.tensor(t, dtype=F32)
        m, v, updates = {}, {}, {}
        for n, g in grads.items():
            gf = g.float()
            m[n] = _put(state["m"][n], b1 * state["m"][n] + (1 - b1) * gf,
                        inplace)
            v[n] = _put(state["v"][n],
                        b2 * state["v"][n] + (1 - b2) * gf ** 2, inplace)
            dev = m[n].device
            mh = m[n] / c1.to(dev)
            vh = v[n] / c2.to(dev)
            p = params[n]
            updates[n] = (-lr.to(dev) * (mh / (torch.sqrt(vh) + eps)
                                         + weight_decay * p.float())
                          ).to(p.dtype)
        return updates, {"m": m, "v": v}

    def structs(shapes):
        return {"m": {n: (tuple(s), F32) for n, s in shapes.items()},
                "v": {n: (tuple(s), F32) for n, s in shapes.items()}}

    return Optimizer(init, update, structs)


def _factored_dims(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr_fn, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              dim_axes: Dict[str, Tuple] = None, nd: int = 0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no momentum.

    ``dim_axes[name] = (last_axes, prev_axes)``: the mesh axes the last /
    second-to-last param dims are sharded over.  ``nd`` is the number of
    leading mesh dims of the stacked tensors (the factoring rule reads the
    local shape).  The factored statistics are means over the full dims,
    so a sharded dim reduces through an explicit OMPCCL mean."""
    dim_axes = dim_axes or {}

    def _pmean(x, axes):
        if not axes:
            return x
        from ..core import ompccl
        from ..core.groups import DiompGroup
        return ompccl.allreduce(x, DiompGroup(tuple(axes)), op="mean")

    def _state_for(p):
        shape = tuple(p.shape)
        if _factored_dims(shape[nd:]):
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=p.device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                      device=p.device)}
        return {"v": torch.zeros(shape, dtype=F32, device=p.device)}

    def init(params):
        return {n: _state_for(p) for n, p in params.items()}

    def update(grads, state, params, step, inplace: bool = False):
        t = torch.tensor(float(step) + 1.0, dtype=F32)
        beta = 1.0 - t ** (-decay)
        lr = lr_fn(step)
        updates, new_state = {}, {}
        for name, g in grads.items():
            st, p = state[name], params[name]
            dev = g.device
            bt, lrt = beta.to(dev), lr.to(dev)
            last_ax, prev_ax = dim_axes.get(name, ((), ()))
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in st:
                vr = bt * st["vr"] + (1 - bt) * _pmean(g2.mean(-1), last_ax)
                vc = bt * st["vc"] + (1 - bt) * _pmean(g2.mean(-2), prev_ax)
                vr_mean = _pmean(vr.mean(-1, keepdim=True), prev_ax)
                denom = (vr / torch.clamp(vr_mean, min=eps))[..., None] \
                    * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                new = {"vr": _put(st["vr"], vr, inplace),
                       "vc": _put(st["vc"], vc, inplace)}
            else:
                v = bt * st["v"] + (1 - bt) * g2
                u = gf * torch.rsqrt(torch.clamp(v, min=eps))
                new = {"v": _put(st["v"], v, inplace)}
            local = _local_dims(u, nd)
            ms = (u * u).mean(local) if local else u * u
            rms = torch.sqrt(_pmean(ms, tuple(last_ax) + tuple(prev_ax))
                             + eps)
            rms = rms.reshape(*rms.shape, *([1] * (u.dim() - rms.dim())))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            updates[name] = (-lrt * u).to(p.dtype)
            new_state[name] = new
        return updates, new_state

    def structs(shapes):
        def f(s):
            s = tuple(s)
            if _factored_dims(s[nd:]):
                return {"vr": (s[:-1], F32), "vc": (s[:-2] + s[-1:], F32)}
            return {"v": (s, F32)}
        return {n: f(s) for n, s in shapes.items()}

    return Optimizer(init, update, structs)


def adafactor_dim_axes(cfg, mesh, rules=None) -> Dict[str, Tuple]:
    """Adafactor's dim_axes table from the schema placement."""
    from ..distributed.sharding import DEFAULT_RULES, logical_to_spec
    from ..models import schema as sch

    def axes_of(part):
        if part is None:
            return ()
        return tuple(part) if isinstance(part, tuple) else (part,)

    out = {}
    for name, meta in sch.build_schema(cfg).items():
        spec = logical_to_spec(meta.axes, mesh, rules or DEFAULT_RULES)
        rank = len(meta.shape)
        parts = list(spec) + [None] * (rank - len(spec))
        out[name] = (axes_of(parts[-1]) if rank >= 1 else (),
                     axes_of(parts[-2]) if rank >= 2 else ())
    return out
