"""Parameter schema — one declarative table per architecture (dense, GQA
MoE, MLA MoE with its leading dense layers and MTP head, VLM, RWKV6 and
Zamba2 families).

Every parameter declares its global shape and *logical* placement axes
once; from that declaration come the materialized init (from a
``torch.Generator`` on a given device) and the per-dim specs that
:func:`repro_torch.interop.stack_shards` takes.  Shardability is decided
against the production TP width (``MAX_TP = 16``), as in the reference.
The audio family is still to port (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..interop import stack_shards
from ..launch.mesh import RankMesh
from .config import ModelConfig

__all__ = [
    "MAX_TP", "ParamSpec", "build_schema", "init_params", "partition_specs",
    "head_parallel", "kv_sharded", "vocab_sharded", "torch_dtype",
]

MAX_TP = 16  # the production "model" axis width

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02
    per_expert: bool = False      # for active-param accounting


def head_parallel(cfg: ModelConfig) -> bool:
    return cfg.num_heads > 0 and cfg.num_heads % MAX_TP == 0


def kv_sharded(cfg: ModelConfig) -> bool:
    return cfg.kv_heads > 0 and cfg.kv_heads % MAX_TP == 0


def vocab_sharded(cfg: ModelConfig) -> bool:
    return cfg.vocab_size % MAX_TP == 0


def _attn_layer(cfg: ModelConfig, L: int, prefix: str,
                s: Dict[str, ParamSpec]) -> None:
    """The GQA attention of one stacked block of decoder layers."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    ha = "heads" if head_parallel(cfg) else None
    ka = "kv_heads" if kv_sharded(cfg) else None
    s[f"{prefix}/attn_norm"] = ParamSpec((L, d), (None, None), init="ones")
    s[f"{prefix}/wq"] = ParamSpec((L, d, H * hd), (None, "embed_fsdp", ha))
    s[f"{prefix}/wk"] = ParamSpec((L, d, KV * hd), (None, "embed_fsdp", ka))
    s[f"{prefix}/wv"] = ParamSpec((L, d, KV * hd), (None, "embed_fsdp", ka))
    if cfg.qkv_bias:
        s[f"{prefix}/bq"] = ParamSpec((L, H * hd), (None, ha), init="zeros")
        s[f"{prefix}/bk"] = ParamSpec((L, KV * hd), (None, ka), init="zeros")
        s[f"{prefix}/bv"] = ParamSpec((L, KV * hd), (None, ka), init="zeros")
    s[f"{prefix}/wo"] = ParamSpec((L, H * hd, d), (None, ha, "embed_fsdp"))


def _dense_layer(cfg: ModelConfig, L: int, d_ff: int, prefix: str,
                 s: Dict[str, ParamSpec]) -> None:
    """One stacked block of standard GQA decoder layers."""
    _attn_layer(cfg, L, prefix, s)
    _mlp(L, cfg.d_model, d_ff, prefix, s)


def _mla_layer(cfg: ModelConfig, L: int, prefix: str,
               s: Dict[str, ParamSpec]) -> None:
    """DeepSeek's multi-head latent attention of one stacked block (its FFN
    slot is added separately, dense or MoE): the low-rank q and kv
    projections replicated over "model", their up-projections and the
    output head-sharded."""
    d, H = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ha = "heads" if head_parallel(cfg) else None
    s[f"{prefix}/attn_norm"] = ParamSpec((L, d), (None, None), init="ones")
    s[f"{prefix}/wq_a"] = ParamSpec((L, d, qr), (None, "embed_fsdp", None))
    s[f"{prefix}/q_norm"] = ParamSpec((L, qr), (None, None), init="ones")
    s[f"{prefix}/wq_b"] = ParamSpec((L, qr, H * (dn + dr)),
                                    (None, "embed_fsdp", ha))
    s[f"{prefix}/wkv_a"] = ParamSpec((L, d, kr + dr),
                                     (None, "embed_fsdp", None))
    s[f"{prefix}/kv_norm"] = ParamSpec((L, kr), (None, None), init="ones")
    s[f"{prefix}/wkv_b"] = ParamSpec((L, kr, H * (dn + dv)),
                                     (None, "embed_fsdp", ha))
    s[f"{prefix}/wo"] = ParamSpec((L, H * dv, d), (None, ha, "embed_fsdp"))


def _mlp(L: int, d: int, d_ff: int, prefix: str,
         s: Dict[str, ParamSpec]) -> None:
    """A stacked SwiGLU MLP and its norm (column- then row-parallel)."""
    s[f"{prefix}/mlp_norm"] = ParamSpec((L, d), (None, None), init="ones")
    s[f"{prefix}/w_gate"] = ParamSpec((L, d, d_ff), (None, "embed_fsdp", "mlp"))
    s[f"{prefix}/w_up"] = ParamSpec((L, d, d_ff), (None, "embed_fsdp", "mlp"))
    s[f"{prefix}/w_down"] = ParamSpec((L, d_ff, d), (None, "mlp", "embed_fsdp"))


def _moe_ffn(cfg: ModelConfig, L: int, prefix: str,
             s: Dict[str, ParamSpec]) -> None:
    """The routed experts (sharded over "expert") and shared experts of one
    stacked block of MoE layers."""
    d, E, ffm = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s[f"{prefix}/mlp_norm"] = ParamSpec((L, d), (None, None), init="ones")
    s[f"{prefix}/router"] = ParamSpec((L, d, E), (None, None, None),
                                      dtype="float32", scale=0.006)
    s[f"{prefix}/w_gate_e"] = ParamSpec(
        (L, E, d, ffm), (None, "expert", "embed_fsdp", None), per_expert=True)
    s[f"{prefix}/w_up_e"] = ParamSpec(
        (L, E, d, ffm), (None, "expert", "embed_fsdp", None), per_expert=True)
    s[f"{prefix}/w_down_e"] = ParamSpec(
        (L, E, ffm, d), (None, "expert", None, "embed_fsdp"), per_expert=True)
    if cfg.shared_experts:
        ffs = ffm * cfg.shared_experts
        s[f"{prefix}/w_gate_s"] = ParamSpec((L, d, ffs), (None, "embed_fsdp", "mlp"))
        s[f"{prefix}/w_up_s"] = ParamSpec((L, d, ffs), (None, "embed_fsdp", "mlp"))
        s[f"{prefix}/w_down_s"] = ParamSpec((L, ffs, d), (None, "mlp", "embed_fsdp"))


def _rwkv_layer(cfg: ModelConfig, L: int, s: Dict[str, ParamSpec]) -> None:
    """RWKV6: time mix (token-shift mixes, decay LoRA, bonus, head norm)
    and channel mix, heads sharded over "model"."""
    d, ff, lora = cfg.d_model, cfg.d_ff, 64
    s["layers/ln1"] = ParamSpec((L, 2, d), (None, None, None), init="ones")
    s["layers/ln2"] = ParamSpec((L, 2, d), (None, None, None), init="ones")
    # time-mix: token-shift mixing coefficients for (r, k, v, w, g)
    s["layers/tm_mu"] = ParamSpec((L, 5, d), (None, None, None), init="ones",
                                  scale=0.5)
    s["layers/tm_w0"] = ParamSpec((L, d), (None, "heads"), init="zeros")
    s["layers/tm_wA"] = ParamSpec((L, d, lora), (None, None, None), scale=0.01)
    s["layers/tm_wB"] = ParamSpec((L, lora, d), (None, None, "heads"),
                                  scale=0.01)
    s["layers/tm_u"] = ParamSpec((L, d), (None, "heads"), init="zeros")
    for nm in ("wr", "wk", "wv", "wg"):
        s[f"layers/tm_{nm}"] = ParamSpec((L, d, d),
                                         (None, "embed_fsdp", "heads"))
    s["layers/tm_lnx"] = ParamSpec((L, d), (None, "heads"), init="ones")
    s["layers/tm_wo"] = ParamSpec((L, d, d), (None, "heads", "embed_fsdp"))
    # channel-mix
    s["layers/cm_mu"] = ParamSpec((L, 2, d), (None, None, None), init="ones",
                                  scale=0.5)
    s["layers/cm_wk"] = ParamSpec((L, d, ff), (None, "embed_fsdp", "mlp"))
    s["layers/cm_wv"] = ParamSpec((L, ff, d), (None, "mlp", "embed_fsdp"))
    s["layers/cm_wr"] = ParamSpec((L, d, d), (None, "embed_fsdp", "heads"))


def _mamba_layer(cfg: ModelConfig, L: int, s: Dict[str, ParamSpec]) -> None:
    """Mamba2: inner dim 2·d in heads of 64 sharded over "model"; the B/C
    projection replicated."""
    d = cfg.d_model
    din = 2 * d
    nh = din // 64
    st, cw = cfg.ssm_state, cfg.conv_width
    s["layers/norm"] = ParamSpec((L, d), (None, None), init="ones")
    s["layers/w_x"] = ParamSpec((L, d, din), (None, "embed_fsdp", "heads"))
    s["layers/w_z"] = ParamSpec((L, d, din), (None, "embed_fsdp", "heads"))
    s["layers/w_bc"] = ParamSpec((L, d, 2 * st), (None, "embed_fsdp", None))
    s["layers/w_dt"] = ParamSpec((L, d, nh), (None, "embed_fsdp", "heads"))
    s["layers/dt_bias"] = ParamSpec((L, nh), (None, "heads"), init="zeros")
    s["layers/conv_w"] = ParamSpec((L, cw, din), (None, None, "heads"),
                                   scale=0.1)
    s["layers/conv_b"] = ParamSpec((L, din), (None, "heads"), init="zeros")
    s["layers/A_log"] = ParamSpec((L, nh), (None, "heads"), init="zeros")
    s["layers/D"] = ParamSpec((L, nh), (None, "heads"), init="ones")
    s["layers/out_norm"] = ParamSpec((L, din), (None, "heads"), init="ones")
    s["layers/w_out"] = ParamSpec((L, din, d), (None, "heads", "embed_fsdp"))


def _shared_block(cfg: ModelConfig, s: Dict[str, ParamSpec]) -> None:
    """Zamba2's SHARED attention+MLP block: one parameter set, reused."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    ha = "heads" if head_parallel(cfg) else None
    ka = "kv_heads" if kv_sharded(cfg) else None
    s["shared/attn_norm"] = ParamSpec((d,), (None,), init="ones")
    s["shared/wq"] = ParamSpec((d, H * hd), ("embed_fsdp", ha))
    s["shared/wk"] = ParamSpec((d, KV * hd), ("embed_fsdp", ka))
    s["shared/wv"] = ParamSpec((d, KV * hd), ("embed_fsdp", ka))
    s["shared/wo"] = ParamSpec((H * hd, d), (ha, "embed_fsdp"))
    s["shared/mlp_norm"] = ParamSpec((d,), (None,), init="ones")
    s["shared/w_gate"] = ParamSpec((d, cfg.d_ff), ("embed_fsdp", "mlp"))
    s["shared/w_up"] = ParamSpec((d, cfg.d_ff), ("embed_fsdp", "mlp"))
    s["shared/w_down"] = ParamSpec((cfg.d_ff, d), ("mlp", "embed_fsdp"))


def build_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family!r} family's schema is not ported yet: ROADMAP "
            f"queue 1, item 9")
    s: Dict[str, ParamSpec] = {}
    d, V = cfg.d_model, cfg.vocab_size
    va = "vocab" if vocab_sharded(cfg) else None
    s["embed/table"] = ParamSpec((V, d), (va, None), scale=1.0)
    s["final_norm"] = ParamSpec((d,), (None,), init="ones")
    if cfg.family in ("dense", "vlm"):
        _dense_layer(cfg, cfg.num_layers, cfg.d_ff, "layers", s)
    elif cfg.family == "moe":
        kd = cfg.first_k_dense
        Lm = cfg.num_layers - kd
        if cfg.attention == "mla":   # deepseek: kd dense layers, then MoE
            if kd:
                _mla_layer(cfg, kd, "dense_layers", s)
                _mlp(kd, d, cfg.d_ff, "dense_layers", s)
            _mla_layer(cfg, Lm, "layers", s)
        else:                        # GQA MoE (qwen3)
            _attn_layer(cfg, Lm, "layers", s)
        _moe_ffn(cfg, Lm, "layers", s)
        if cfg.mtp:  # the multi-token-prediction head (a training loss term)
            s["mtp/proj"] = ParamSpec((2 * d, d), ("embed_fsdp", None))
            s["mtp/norm_h"] = ParamSpec((d,), (None,), init="ones")
            s["mtp/norm_e"] = ParamSpec((d,), (None,), init="ones")
            _mla_layer(cfg, 1, "mtp/layer", s)
            _mlp(1, d, cfg.moe_d_ff * max(cfg.shared_experts, 1),
                 "mtp/layer", s)
    elif cfg.family == "ssm":  # rwkv6
        s["embed_norm"] = ParamSpec((2, d), (None, None), init="ones")
        _rwkv_layer(cfg, cfg.num_layers, s)
    else:  # hybrid (zamba2): mamba layers and the shared block
        _mamba_layer(cfg, cfg.num_layers, s)
        _shared_block(cfg, s)
    if cfg.family != "vlm":          # the VLM's logits reuse embed/table
        s["lm_head"] = ParamSpec((d, V), (None, va))
    return s


def partition_specs(cfg: ModelConfig, mesh: RankMesh,
                    rules=None) -> Dict[str, tuple]:
    """One spec per param, one entry per dim (``stack_shards``' currency)."""
    from ..distributed.sharding import DEFAULT_RULES, logical_to_spec

    rules = rules or DEFAULT_RULES
    return {name: logical_to_spec(spec.axes, mesh, rules)
            for name, spec in build_schema(cfg).items()}


def init_params(cfg: ModelConfig, mesh: RankMesh, generator: torch.Generator,
                *, device="cuda", rules=None) -> Dict[str, torch.Tensor]:
    """Random parameters as stacked per-rank tensors on ``device``.

    Each global parameter is drawn in its own dtype from ``generator``
    (which must live on ``device``), in the schema's sorted order, with the
    reference's scales (std = min(scale, 1/sqrt(fan_in))), then split over
    the mesh by ``partition_specs``.  The reference draws from a JAX key, so
    the two packages' random weights differ; tests carry the reference's
    weights over with :func:`repro_torch.interop.params_from_reference`.
    """
    specs = partition_specs(cfg, mesh, rules)
    out = {}
    for name, spec in sorted(build_schema(cfg).items()):
        dt = torch_dtype(spec.dtype)
        if spec.init == "zeros":
            w = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            w = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = min(spec.scale, 1.0 / math.sqrt(max(fan_in, 1)))
            w = torch.empty(spec.shape, dtype=dt, device=device).normal_(
                0.0, std, generator=generator)
        out[name] = stack_shards(w, mesh, specs[name], device=device)
        del w
    return out
