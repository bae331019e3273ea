"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) moe_d_ff=1536 vocab=151936, no shared
expert, no qkv bias, head_dim=128.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    attention="gqa",
    rope_theta=1_000_000.0,
    moe=True,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
)

REDUCED = ModelConfig(
    name="qwen3-moe-235b-a22b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=16,
    kv_heads=4,
    head_dim=4,
    d_ff=32,
    vocab_size=160,
    attention="gqa",
    moe=True,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    capacity_factor=2.0,
)
