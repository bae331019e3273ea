"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  The SigLIP
frontend is a stub, as in the reference: a caller supplies precomputed
patch embeddings (``prefix_embeds``) under gemma's prefix-LM window.  8
heads do not divide MAX_TP=16, so attention is token-parallel (all-gathered
K/V, or the fused ring under ``seq_parallel="ring"``).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10_000.0,
    prefix_tokens=256,
)

REDUCED = ModelConfig(
    name="paligemma-3b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=8,
    kv_heads=1,
    head_dim=8,
    d_ff=128,
    vocab_size=160,
    prefix_tokens=8,
)
