"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.  StableLM uses
partial rotary (25%).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope_fraction=0.25,
)

REDUCED = ModelConfig(
    name="stablelm-3b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=16,
    kv_heads=16,
    head_dim=4,
    d_ff=128,
    vocab_size=160,
    rope_fraction=0.25,
)
