"""Global arrays <-> stacked rank tensors.

The reference feeds ``shard_map`` global arrays with a partition spec per
dimension (``P("z", "y")``, ``P("ring", None)``, ``P(None, "ring")``); the
port holds the same data as one stacked tensor whose leading dims are the
mesh axes.  These two functions carry fields, matrices and velocity models
between the two layouts, so both packages compute on the same data.

A spec has one entry per global dimension: a mesh axis name, a tuple of
axis names (row-major over them), or None (not sharded).  A mesh axis no
entry names holds replicas.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .launch.mesh import RankMesh

__all__ = ["stack_shards", "unstack_shards", "local_shape",
           "params_from_reference"]

SpecEntry = Union[None, str, Tuple[str, ...]]


def _axes_of(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(mesh: RankMesh, spec: Sequence[SpecEntry], ndim: int):
    if len(spec) != ndim:
        raise ValueError(f"spec {tuple(spec)} has {len(spec)} entries for "
                         f"{ndim} dims")
    used = [ax for e in spec for ax in _axes_of(e)]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {tuple(spec)} names a mesh axis twice")
    for ax in used:
        mesh.dim(ax)
    return used


def stack_shards(global_array, mesh: RankMesh, spec: Sequence[SpecEntry],
                 *, device="cpu", dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Global array -> stacked tensor ``(*mesh.sizes, *local_shape)``."""
    g = torch.as_tensor(np.array(global_array, order="C")) \
        if isinstance(global_array, np.ndarray) else torch.as_tensor(global_array)
    _check_spec(mesh, spec, g.dim())
    shape, order = [], []            # split every sharded dim into its axes
    for d, e in enumerate(spec):
        axes = _axes_of(e)
        sizes = [mesh.shape[a] for a in axes]
        n = int(np.prod(sizes)) if sizes else 1
        if g.shape[d] % n:
            raise ValueError(f"dim {d} of extent {g.shape[d]} does not split "
                             f"over {axes}")
        for a, s in zip(axes, sizes):
            order.append(("mesh", a, len(shape)))
            shape.append(s)
        order.append(("local", d, len(shape)))
        shape.append(g.shape[d] // n)
    t = g.reshape(shape)
    mesh_pos = {a: pos for kind, a, pos in order if kind == "mesh"}
    local_pos = [pos for kind, _, pos in order if kind == "local"]
    lead = []
    for a in mesh.axis_names:
        if a not in mesh_pos:            # replicated over this axis
            t = t.unsqueeze(-1)
            mesh_pos[a] = t.dim() - 1
        lead.append(mesh_pos[a])
    t = t.permute(lead + local_pos)
    t = t.expand(*mesh.sizes, *t.shape[mesh.ndim:])
    return t.to(device=device, dtype=dtype).contiguous()


def unstack_shards(stacked: torch.Tensor, mesh: RankMesh,
                   spec: Sequence[SpecEntry]) -> np.ndarray:
    """Inverse of :func:`stack_shards`; replicas are read from index 0.
    bfloat16 comes back as float32 (numpy has no bfloat16)."""
    t = stacked.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    nloc = t.dim() - mesh.ndim
    used = _check_spec(mesh, spec, nloc)
    for a in reversed(mesh.axis_names):           # drop replica axes
        if a not in used:
            t = t.select(mesh.dim(a), 0)
    kept = [a for a in mesh.axis_names if a in used]
    perm, shape = [], []
    for d, e in enumerate(spec):
        axes = _axes_of(e)
        perm += [kept.index(a) for a in axes] + [len(kept) + d]
        shape.append(int(np.prod([mesh.shape[a] for a in axes]))
                     * t.shape[len(kept) + d])
    return t.permute(perm).reshape(shape).numpy()


def local_shape(global_shape: Sequence[int], mesh: RankMesh,
                spec: Sequence[SpecEntry]) -> Tuple[int, ...]:
    """The stacked shape ``(*mesh.sizes, *local_shape)`` of a global
    array laid out by ``spec``."""
    _check_spec(mesh, spec, len(global_shape))
    local = []
    for n, e in zip(global_shape, spec):
        div = int(np.prod([mesh.shape[a] for a in _axes_of(e)]))
        if n % div:
            raise ValueError(f"extent {n} does not split over {e}")
        local.append(n // div)
    return (*mesh.sizes, *local)


def params_from_reference(cfg, mesh: RankMesh, np_params, *, device="cpu",
                          dtype: Optional[torch.dtype] = None, rules=None):
    """The reference's parameters (a dict of numpy arrays, global view) as
    the port's stacked per-rank tensors, split by the schema's
    ``partition_specs``.  Each lands in its schema dtype unless ``dtype``
    is given (numpy has no bfloat16: pass bf16 weights as float32)."""
    from .models.schema import build_schema, partition_specs, torch_dtype

    schema = build_schema(cfg)
    specs = partition_specs(cfg, mesh, rules)
    if set(np_params) != set(schema):
        raise ValueError(f"parameter names differ from the schema: "
                         f"{sorted(set(np_params) ^ set(schema))}")
    return {name: stack_shards(
                np.asarray(np_params[name]), mesh, specs[name], device=device,
                dtype=dtype or torch_dtype(schema[name].dtype))
            for name in sorted(schema)}
