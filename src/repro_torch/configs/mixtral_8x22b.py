"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    sliding_window=32,
    attn_chunk=16,
    xent_chunk=32,
)
