"""hubert-xlarge [audio] — encoder-only masked prediction
[arXiv:2106.07447; unverified].

48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 (cluster targets).  The
conv waveform frontend is a stub: the batch supplies precomputed frame
embeddings.  Encoder-only: no decode step.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope_fraction=0.0,       # sinusoidal additive positions (no rotary)
)

REDUCED = ModelConfig(
    name="hubert-xlarge-reduced",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=16,
    kv_heads=16,
    head_dim=4,
    d_ff=128,
    vocab_size=24,
    causal=False,
    rope_fraction=0.0,
)
