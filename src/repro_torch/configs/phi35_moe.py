"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    attn_chunk=32,
    xent_chunk=32,
)
