"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen1.5-110b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=16,
    kv_heads=8,
    head_dim=4,
    d_ff=128,
    vocab_size=160,
    qkv_bias=True,
)
