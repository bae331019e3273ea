"""glm4-9b [dense] — RoPE (partial), GQA [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.  GLM uses
half-dim rotary (rope_fraction=0.5).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_fraction=0.5,
)

REDUCED = ModelConfig(
    name="glm4-9b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=16,
    kv_heads=2,
    head_dim=4,
    d_ff=128,
    vocab_size=160,
    rope_fraction=0.5,
)
