"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    rope_theta=10000.0,
    attn_chunk=32,
    xent_chunk=32,
)
