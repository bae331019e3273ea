"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.  O(1) decode
state -> runs long_500k natively.  The attention-sharding aspects of the
runtime do not apply (no attention); the OMPCCL runtime drives all
projections and channel-mix reductions.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    rwkv_head_dim=64,
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced",
    family="ssm",
    num_layers=2,
    d_model=512,
    num_heads=0,
    kv_heads=0,
    head_dim=0,
    d_ff=1024,
    vocab_size=160,
    attention="none",
    rwkv_head_dim=64,
)
