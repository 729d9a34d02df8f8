"""qwen2-7b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    rope_theta=10000.0,
    attn_chunk=32,
    xent_chunk=32,
)
