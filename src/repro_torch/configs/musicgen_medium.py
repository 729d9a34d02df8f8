"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]

The EnCodec frontend (4 codebooks, delay pattern) is a STUB per the brief:
``input_specs()`` provides precomputed frame embeddings (B, S, d); the loss
head predicts the 2048-entry codebook vocabulary.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    embeddings_provided=True,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=4,
    head_dim=12,
    d_ff=96,
    vocab_size=128,
    embeddings_provided=True,
    attn_chunk=32,
    xent_chunk=32,
)
