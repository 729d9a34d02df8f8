"""llama-3.2-vision-11b [vlm] — text decoder with cross-attention image
layers every 5th layer. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB: ``input_specs()`` provides projected patch
embeddings (B, T_img, d) consumed by the cross-attention layers.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cycle=("attn",) * 4 + ("cross_attn",),
    cross_attn_tokens=4096,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-smoke",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cycle=("attn",) * 4 + ("cross_attn",),
    cross_attn_tokens=64,
    attn_chunk=32,
    xent_chunk=32,
)
