"""command-r-plus-104b [dense] — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
)

REDUCED = ModelConfig(
    name="command-r-plus-104b-reduced",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=16,          # 96 q-heads reduced to 16 (keeps hp path)
    kv_heads=8,
    head_dim=6,
    d_ff=192,
    vocab_size=160,
)
