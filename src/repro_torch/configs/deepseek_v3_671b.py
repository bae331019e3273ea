"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H (MLA) moe_d_ff=2048 vocab=129280, 256 experts top-8,
first 3 layers dense (d_ff=18432), q_lora=1536, kv_lora=512,
qk nope/rope = 128/64, v_head=128.  Trains with Adafactor (Adam state for
671B params does not fit the 256x16 GB plan).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    kv_heads=128,
    head_dim=192,            # qk head dim (nope 128 + rope 64)
    d_ff=18432,              # the dense (first-3) layers' FFN
    vocab_size=129280,
    attention="mla",
    moe=True,
    num_experts=256,
    experts_per_token=8,
    moe_d_ff=2048,
    shared_experts=1,
    first_k_dense=3,
    mtp=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
)

REDUCED = ModelConfig(
    name="deepseek-v3-671b-reduced",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=16,
    kv_heads=16,
    head_dim=12,
    d_ff=128,
    vocab_size=160,
    attention="mla",
    moe=True,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    shared_experts=1,
    first_k_dense=1,
    mtp=True,
    q_lora_rank=32,
    kv_lora_rank=32,
    qk_rope_head_dim=4,
    qk_nope_head_dim=8,
    v_head_dim=8,
    capacity_factor=2.0,
)
