"""Model + parallelism configuration shared by every architecture."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.groups import DiompGroup, standard_groups
from ..distributed.buckets import DEFAULT_BUCKET_BYTES
from ..launch.mesh import RankMesh

__all__ = ["ModelConfig", "ParallelCtx", "DEFAULT_BUCKET_BYTES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field names follow the reference."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int = 0
    head_dim: int = 0            # derived if 0: d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    attention: str = "gqa"       # gqa | mla | none
    causal: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0

    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    mtp: bool = False

    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    ssm_state: int = 0
    ssm_heads: int = 0
    conv_width: int = 4
    attn_every: int = 0
    rwkv_head_dim: int = 64

    prefix_tokens: int = 0

    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameters (exact, from the schema)."""
        from . import schema
        total = 0
        for s in schema.build_schema(self).values():
            n = 1
            for d in s.shape:
                n *= int(d)
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Static parallel layout for one mesh — sizes + DiOMP group handles.

    Knobs keep the reference's names and defaults; the ones whose paths are
    not ported raise where a step builder resolves them.
    """

    tp: int
    fsdp: int
    dp: int
    pods: int
    tp_group: DiompGroup
    fsdp_group: DiompGroup
    dp_group: DiompGroup
    ep_group: DiompGroup
    world: DiompGroup
    pod_group: Optional[DiompGroup] = None

    dp_backend: str = "hierarchical"
    grad_codec: str = "none"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    overlap_grad_reduce: bool = True
    use_ring_matmul: bool = False
    ring_impl: str = "auto"
    dispatch_impl: str = "auto"
    seq_parallel: str = "auto"
    remat: bool = True
    microbatch: int = 1
    seq_shard: bool = False
    explicit_dp: bool = True
    inference: bool = False
    expert2d: bool = False
    fsdp_params: bool = True
    gather_codec: str = "none"
    layout: str = "tp"

    @classmethod
    def from_mesh(cls, mesh: RankMesh, **knobs) -> "ParallelCtx":
        """The layout's sizes and groups on ``mesh``.  ``layout="dp_only"``
        (small dense models whose TP all-reduces dominate) has no tensor
        parallelism: ``tp = 1``, the model axis joins the data-parallel
        domain (``dp_all`` over pod, data and model), and the TP and EP
        groups are the empty ``self`` group.  ``expert2d=True`` shards the
        MoE experts over model x data: the EP group is ``ep2d`` over
        ("model", "data"), its rank model-major, and each rank owns whole
        experts at full d and ff."""
        g = standard_groups(mesh)
        shape = mesh.shape
        tp = shape.get("model", 1)
        fsdp = shape.get("data", 1)
        pods = shape.get("pod", 1)
        if knobs.get("layout", "tp") == "dp_only":
            dp_axes = tuple(a for a in ("pod", "data", "model")
                            if a in shape)
            return cls(
                tp=1, fsdp=fsdp, dp=fsdp * pods * tp, pods=pods,
                tp_group=DiompGroup((), name="self"),
                fsdp_group=g.get("dp_inner",
                                 DiompGroup(("data",), name="dp_inner")),
                dp_group=DiompGroup(dp_axes, name="dp_all"),
                ep_group=DiompGroup((), name="self"),
                world=g["world"],
                pod_group=g.get("pod"),
                **knobs,
            )
        if knobs.get("layout", "tp") != "tp":
            raise ValueError(f"unknown layout {knobs['layout']!r} (tp or "
                             f"dp_only)")
        ep_group = (DiompGroup(("model", "data"), name="ep2d")
                    if knobs.get("expert2d") else
                    g.get("ep", DiompGroup(("model",), name="ep")))
        return cls(
            tp=tp, fsdp=fsdp, dp=fsdp * pods, pods=pods,
            tp_group=g.get("tp", DiompGroup(("model",), name="tp")),
            fsdp_group=g.get("dp_inner",
                             DiompGroup(("data",), name="dp_inner")),
            dp_group=g["dp"],
            ep_group=ep_group,
            world=g["world"],
            pod_group=g.get("pod"),
            **knobs,
        )

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return self.dp_group.axes

    @property
    def ep_size(self) -> int:
        """Ranks in the EP group, from the stored axis sizes."""
        n = 1
        for ax in self.ep_group.axes:
            n *= {"model": self.tp, "data": self.fsdp, "pod": self.pods}[ax]
        return n
