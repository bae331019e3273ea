"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.  The
shared attention+MLP block (one parameter set, reused) is applied after
every 6 mamba layers (the release interleaves two shared blocks with LoRA
adapters — adapters omitted, as in the reference).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    conv_width=4,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=256,
    num_heads=16,
    kv_heads=16,
    head_dim=16,
    d_ff=512,
    vocab_size=160,
    ssm_state=32,
    attn_every=2,
    conv_width=4,
)
