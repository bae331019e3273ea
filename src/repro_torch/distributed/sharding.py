"""Logical-axis sharding rules (MaxText-style), ported from the reference.

Model code annotates every parameter with *logical* axis names ("embed",
"mlp", "heads", "vocab", ...).  A rule table translates them to *mesh*
axes — the counterpart of DiOMP's PGAS placement decisions.  Rules are
ordered: the first mesh axis in a rule's list that exists in the mesh AND
is not already taken by another dim wins; ``None`` means replicated.

A spec here is a tuple with one entry per dim — a mesh axis, a tuple of
them, or None — which is what :func:`repro_torch.interop.stack_shards`
takes.  In place of ``NamedSharding``, :class:`RankSharding` carries the
mesh and that spec: a stacked tensor already holds every rank, so nothing
more is needed to place one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from ..launch.mesh import RankMesh

__all__ = ["ShardingRules", "DEFAULT_RULES", "EXPERT2D_RULES",
           "DP_ONLY_RULES", "rules_for_ctx", "logical_to_spec", "RankSharding",
           "named_sharding", "param_bytes_per_device"]

POD, DATA, MODEL = "pod", "data", "model"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> candidate mesh axes (first available wins)."""

    rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...]

    def lookup(self, logical: Optional[str], mesh: RankMesh, taken: set):
        if logical is None:
            return None
        for name, candidates in self.rules:
            if name != logical:
                continue
            picked: List[str] = [c for c in candidates if c is not None
                                 and c in mesh.shape and c not in taken]
            if not picked:
                return None
            taken.update(picked)
            return picked[0] if len(picked) == 1 else tuple(picked)
        return None

    def replace(self, logical: str,
                candidates: Tuple[Optional[str], ...]) -> "ShardingRules":
        """A copy with one rule overridden (or appended)."""
        new = [(n, candidates if n == logical else c) for n, c in self.rules]
        if logical not in dict(self.rules):
            new.append((logical, candidates))
        return ShardingRules(tuple(new))


# the reference's default placement on a ("pod", "data", "model") mesh
DEFAULT_RULES = ShardingRules(
    rules=(
        ("batch", (POD, DATA)),
        ("seq", (None,)),
        ("seq_shard", (MODEL,)),
        ("embed", (None,)),
        ("embed_fsdp", (DATA,)),
        ("heads", (MODEL,)),
        ("kv_heads", (MODEL,)),
        ("mlp", (MODEL,)),
        ("vocab", (MODEL,)),
        ("expert", (MODEL,)),
        ("expert_mlp", (None,)),
        ("conv_state", (None,)),
        ("ssm_state", (None,)),
        ("stage", (None,)),
    )
)


# MoE experts over model x data (each rank whole experts at full d and ff,
# the dispatch over the combined EP group, no ZeRO-3 gather of them)
EXPERT2D_RULES = DEFAULT_RULES.replace("expert", (MODEL, DATA))

# no tensor parallelism: the batch over every mesh axis, and every rule
# that could only pick "model" replicated (small dense models whose TP
# activation all-reduces dominate)
DP_ONLY_RULES = ShardingRules(rules=tuple(
    (name, (POD, DATA, MODEL)) if name == "batch" else
    (name, (None,)) if cands and set(cands) <= {MODEL} else
    (name, cands)
    for name, cands in DEFAULT_RULES.rules
))


def rules_for_ctx(ctx) -> ShardingRules:
    """The placement-rule table for a ParallelCtx's layout knobs."""
    if getattr(ctx, "layout", "tp") == "dp_only":
        return DP_ONLY_RULES
    # expert2d: the expert dim takes both axes first, so the expert
    # weights' d and ff dims find "data" taken (whole experts a rank)
    rules = EXPERT2D_RULES if getattr(ctx, "expert2d", False) \
        else DEFAULT_RULES
    if not getattr(ctx, "fsdp_params", True):
        # inference weight-stationary: dense weights TP-sharded only
        rules = rules.replace("embed_fsdp", (None,))
    return rules


def logical_to_spec(logical_axes: Sequence[Optional[str]], mesh: RankMesh,
                    rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """Logical axis names -> a spec with one entry per dim."""
    taken: set = set()
    return tuple(rules.lookup(ax, mesh, taken) for ax in logical_axes)


@dataclasses.dataclass(frozen=True)
class RankSharding:
    """The placement of one stacked tensor: the mesh and a spec with one
    entry per dim (the counterpart of ``NamedSharding``)."""

    mesh: RankMesh
    spec: tuple


def named_sharding(logical_axes: Sequence[Optional[str]], mesh: RankMesh,
                   rules: ShardingRules = DEFAULT_RULES) -> RankSharding:
    return RankSharding(mesh, logical_to_spec(logical_axes, mesh, rules))


def param_bytes_per_device(shape: Sequence[int], dtype_bytes: int,
                           logical_axes: Sequence[Optional[str]],
                           mesh: RankMesh,
                           rules: ShardingRules = DEFAULT_RULES) -> int:
    """Local shard size in bytes — what GlobalMemory charges the arena;
    a dim its axes do not divide is padded (ceil-division)."""
    spec = logical_to_spec(logical_axes, mesh, rules)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for dim, part in zip(shape, parts):
        axes = () if part is None else \
            (part if isinstance(part, tuple) else (part,))
        n *= -(-dim // math.prod(mesh.shape[ax] for ax in axes))
    return n * dtype_bytes
