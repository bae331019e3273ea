"""Gradient bucketing — the planned flat-bucket DP reduction.

The reference's ``repro/distributed/buckets.py`` on stacked ranks.  A
per-parameter reduction pays one collective launch per tensor;
:class:`BucketPlanner` turns the parameter schema into a plan instead:

* the gradients are partitioned by ``(group of unreduced DP axes, wire
  dtype, duplication factor)``, so every member of a partition needs the
  same collective and the same 1/dup weight in the global norm;
* each partition is packed, in sorted name order, into flat f32 buckets of
  at most ``bucket_bytes`` (a parameter may straddle buckets), so a
  partition of ``T`` payload bytes issues ``ceil(T / bucket_bytes)``
  collectives;
* every bucket is padded once, in the layout, to a multiple of its group
  size (times the int8 block under the codec), so no collective pads.

The plan is pure static-shape data, equal record for record to the
reference's for the same schema and mesh.  Pack and unpack are index
maps over stacked tensors ``(*mesh, ...)``: a bucket is ``(*mesh,
padded_size)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..core.context import default_context
from ..core.groups import DiompGroup, group_for_axes

__all__ = [
    "DEFAULT_BUCKET_BYTES",
    "GRAD_QUANT_BLOCK",
    "BucketSlice",
    "Bucket",
    "BucketPlan",
    "BucketPlanner",
    "spec_axes",
    "unreduced_dp_axes",
    "local_shape",
    "duplication_factor",
    "plan_for_config",
    "pack_buckets",
    "unpack_buckets",
    "backend_for_axes",
    "backend_for_bucket",
    "reduce_bucketed",
]

WIRE_ITEMSIZE = 4                  # buckets reduce in f32
DEFAULT_BUCKET_BYTES = 4 * 2**20
GRAD_QUANT_BLOCK = 1024            # int8 per-block scale granularity


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def spec_axes(pspec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in order."""
    return tuple(ax for part in pspec for ax in _axes_of(part))


def unreduced_dp_axes(pspec, dp_axes) -> Tuple[str, ...]:
    """The DP axes a parameter's sharding does NOT consume: the axes its
    gradient still needs a cross-rank reduction over."""
    used = spec_axes(pspec)
    return tuple(a for a in dp_axes if a not in used)


def local_shape(shape: Sequence[int], pspec,
                mesh_sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """Per-rank shard shape of a global tensor under ``pspec``."""
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    out = []
    for dim, part in zip(shape, parts):
        div = 1
        for ax in _axes_of(part):
            div *= mesh_sizes[ax]
        out.append(dim // div)
    return tuple(out)


def duplication_factor(pspec, mesh_sizes: Mapping[str, int]) -> int:
    """Rank copies per element: world size / sharded ways (the 1/dup weight
    of the global norm)."""
    world = 1
    for s in mesh_sizes.values():
        world *= s
    sharded = 1
    for ax in spec_axes(pspec):
        sharded *= mesh_sizes[ax]
    return world // sharded


# ---------------------------------------------------------------------------
# the plan objects
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketSlice:
    """One contiguous run of a parameter's flattened local gradient:
    ``offset`` inside the bucket, ``start`` inside the parameter."""

    name: str
    offset: int
    start: int
    size: int


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One flat wire payload, reduced by ONE collective on ``group``."""

    key: str
    axes: Tuple[str, ...]
    dtype: str
    dup: int
    index: int
    size: int                       # live elements
    padded_size: int                # size rounded up to the layout multiple
    slices: Tuple[BucketSlice, ...]

    @property
    def group(self) -> DiompGroup:
        return group_for_axes(self.axes)

    def group_size(self, mesh_sizes: Mapping[str, int]) -> int:
        g = 1
        for ax in self.axes:
            g *= mesh_sizes[ax]
        return g

    def shard_size(self, mesh_sizes: Mapping[str, int]) -> int:
        """Per-rank elements of the reduce-scattered bucket (the overlap
        carry), exact since ``padded_size`` is a group-size multiple."""
        return self.padded_size // self.group_size(mesh_sizes)

    @property
    def nbytes(self) -> int:
        return self.size * WIRE_ITEMSIZE

    @property
    def padded_nbytes(self) -> int:
        return self.padded_size * WIRE_ITEMSIZE


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The full reduction schedule for one (config, mesh, ctx)."""

    buckets: Tuple[Bucket, ...]
    local: Tuple[str, ...]          # params needing no cross-rank reduce
    shapes: Mapping[str, Tuple[int, ...]]   # local grad shapes, all params
    dups: Mapping[str, int]         # duplication factor, all params
    bucket_bytes: int

    def bucket_count(self) -> Dict[Tuple[str, ...], int]:
        out: Dict[Tuple[str, ...], int] = {}
        for b in self.buckets:
            out[b.axes] = out.get(b.axes, 0) + 1
        return out

    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketPlanner:
    """Partition + pack the gradients into planned flat buckets.

    ``quant_block`` > 0 aligns every bucket to ``group_size * quant_block``
    (the int8 codec's blocks); otherwise buckets align to the group size.
    """

    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    quant_block: int = 0

    def plan(self, shapes: Mapping[str, Sequence[int]],
             pspecs: Mapping[str, object], dp_axes: Sequence[str],
             mesh_sizes: Mapping[str, int]) -> BucketPlan:
        """The plan from static local shapes: partitions in sorted key
        order, members in sorted name order (deterministic)."""
        dp_axes = tuple(dp_axes)
        parts: Dict[Tuple, list] = {}
        local = []
        loc_shapes = {}
        dups = {}
        for name in sorted(shapes):
            shp = tuple(int(d) for d in shapes[name])
            loc_shapes[name] = shp
            dups[name] = duplication_factor(pspecs[name], mesh_sizes)
            need = unreduced_dp_axes(pspecs[name], dp_axes)
            if not need:
                local.append(name)
                continue
            parts.setdefault((need, "float32", dups[name]), []).append(name)

        # capacity rounds UP to whole elements, so a bucket_bytes off the
        # wire itemsize cannot exceed the ceil(bytes / bucket_bytes) bound
        bucket_elems = max(-(-self.bucket_bytes // WIRE_ITEMSIZE), 1)
        buckets = []
        for (axes, dtype, dup) in sorted(parts):
            names = parts[(axes, dtype, dup)]
            gsize = 1
            for ax in axes:
                gsize *= mesh_sizes[ax]
            align = gsize * (self.quant_block or 1)
            index = 0
            pos = 0
            slices: list = []

            def close():
                nonlocal index, pos, slices
                if not slices:
                    return
                padded = -(-pos // align) * align
                key = f"{'+'.join(axes)}|{dtype}|dup{dup}|{index}"
                buckets.append(Bucket(
                    key=key, axes=axes, dtype=dtype, dup=dup, index=index,
                    size=pos, padded_size=padded, slices=tuple(slices)))
                index += 1
                pos = 0
                slices = []

            for name in names:
                left = 1
                for d in loc_shapes[name]:
                    left *= d
                start = 0
                while left > 0:
                    take = min(bucket_elems - pos, left)
                    slices.append(BucketSlice(name, pos, start, take))
                    pos += take
                    start += take
                    left -= take
                    if pos == bucket_elems:
                        close()
            close()
        return BucketPlan(buckets=tuple(buckets), local=tuple(local),
                          shapes=loc_shapes, dups=dups,
                          bucket_bytes=self.bucket_bytes)


@functools.lru_cache(maxsize=64)
def plan_for_config(cfg, mesh, ctx, *,
                    bucket_bytes: Optional[int] = None) -> BucketPlan:
    """The plan for one (ModelConfig, RankMesh, ParallelCtx), cached so
    every build of a step shares one plan object."""
    from ..models import schema as sch
    from .sharding import rules_for_ctx

    pspecs = sch.partition_specs(cfg, mesh, rules_for_ctx(ctx))
    sizes = mesh.shape
    shapes = {name: local_shape(spec.shape, pspecs[name], sizes)
              for name, spec in sch.build_schema(cfg).items()}
    planner = BucketPlanner(
        bucket_bytes=(ctx.bucket_bytes if bucket_bytes is None
                      else bucket_bytes),
        quant_block=GRAD_QUANT_BLOCK if ctx.grad_codec == "int8" else 0)
    return planner.plan(shapes, pspecs, ctx.dp_group.axes, sizes)


# ---------------------------------------------------------------------------
# pack / unpack (index maps from the plan)
# ---------------------------------------------------------------------------


def pack_buckets(grads: Mapping[str, torch.Tensor], plan: BucketPlan,
                 nd: int) -> Dict[str, torch.Tensor]:
    """Each bucket's member slices flattened, cast to f32 and concatenated
    (zero-padded): ``(*mesh, padded_size)`` per bucket; ``nd`` is the
    number of leading mesh dims."""
    out = {}
    for b in plan.buckets:
        pieces = []
        for s in b.slices:
            g = grads[s.name]
            flat = g.reshape(*g.shape[:nd], -1)
            pieces.append(flat[..., s.start:s.start + s.size].float())
        lead = pieces[0].shape[:-1]
        if b.padded_size > b.size:
            pieces.append(pieces[0].new_zeros(*lead, b.padded_size - b.size))
        out[b.key] = torch.cat(pieces, dim=-1)
    return out


def unpack_buckets(bufs: Mapping[str, torch.Tensor],
                   plan: BucketPlan) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_buckets`: per-param f32 gradients."""
    pieces: Dict[str, list] = {}
    for b in plan.buckets:
        buf = bufs[b.key]
        for s in b.slices:
            pieces.setdefault(s.name, []).append(
                buf[..., s.offset:s.offset + s.size])
    out = {}
    for name, ps in pieces.items():
        flat = ps[0] if len(ps) == 1 else torch.cat(ps, dim=-1)
        out[name] = flat.reshape(*flat.shape[:-1], *plan.shapes[name])
    return out


# ---------------------------------------------------------------------------
# the whole-bucket reduction
# ---------------------------------------------------------------------------


def backend_for_axes(axes: Sequence[str], ctx) -> str:
    """The dp_backend policy, shared by the bucketed and the per-param
    reductions: the pod-aware algorithm only where a group spans pods and
    another axis."""
    if (ctx.dp_backend == "hierarchical" and "pod" in axes
            and len(axes) > 1):
        return "hierarchical"
    return "xla"


def backend_for_bucket(bucket: Bucket, ctx) -> str:
    """The OMPCCL backend one bucket's collective dispatches through."""
    return backend_for_axes(bucket.axes, ctx)


def reduce_bucketed(grads: Mapping[str, torch.Tensor], plan: BucketPlan,
                    ctx, *, errors: Optional[dict] = None, context=None):
    """DP mean-reduction of whole buckets, one communicator handle each.

    Gradients are per rank, stacked.  Each is divided by ``ctx.dp`` and
    summed over its bucket's group; int8 buckets over the whole DP group
    go through the blockwise codec with ONE error-feedback state per
    bucket (the codec is not a communicator call, as in the reference).
    Returns ``(reduced_grads, reduced_bufs, new_errors)``: the reduced
    flat buckets ride along for the bucket-wise global norm.
    """
    from .compression import compressed_allreduce

    dctx = context or default_context()
    mesh = dctx.require_mesh()
    dp_axes = tuple(ctx.dp_group.axes)
    if errors and plan.buckets and not any(b.key in errors
                                           for b in plan.buckets):
        # a name-keyed residual from a per-param caller: reducing with
        # error=None would silently drop the accumulated int8 feedback
        raise ValueError(
            "error-feedback state keys match no bucket in the plan "
            f"(got {sorted(errors)[:3]}...); carried per-param errors? "
            "pass bucket_bytes=0 / plan=None to stay on the per-param path")
    out = {n: grads[n].float() / ctx.dp for n in plan.local}
    bufs = pack_buckets(grads, plan, mesh.ndim)
    new_errors = {}
    red = {}
    for b in plan.buckets:
        if ctx.grad_codec == "int8" and set(b.axes) == set(dp_axes):
            # the codec returns the group MEAN over the bucket's group,
            # which IS the dp group here: the raw sum goes in
            err = errors.get(b.key) if errors else None
            buf, e = compressed_allreduce(bufs[b.key], b.group, mesh,
                                          error=err, block=GRAD_QUANT_BLOCK)
            new_errors[b.key] = e
        else:
            comm = dctx.communicator(b.group, backend_for_bucket(b, ctx))
            buf = comm.allreduce(bufs[b.key] / ctx.dp)
        red[b.key] = buf
    out.update(unpack_buckets(red, plan))
    return out, red, new_errors
