"""qwen3-32b [dense] — qk-norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
    attn_chunk=32,
    xent_chunk=32,
)
