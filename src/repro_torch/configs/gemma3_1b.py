"""gemma3-1b [dense] — 5:1 local:global attention, 256k vocab, MQA (kv=1).

[hf:google/gemma-3-1b-pt; unverified]. 26 layers is not a multiple of 6, so
the 5:1 pattern is expressed as a 13-layer cycle (5L,1G,5L,1G,1L) x 2 —
globals at depths 5,11,18,24 vs the reference 5,11,17,23 (DESIGN.md §7).
"""

from repro_torch.models.config import ModelConfig

_CYCLE = ("local_attn",) * 5 + ("attn",) + ("local_attn",) * 5 + ("attn",) + (
    "local_attn",
)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    cycle=_CYCLE,
    local_window=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke",
    family="dense",
    num_layers=13,
    d_model=48,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    cycle=_CYCLE,
    local_window=16,
    tie_embeddings=True,
    attn_chunk=16,
    xent_chunk=32,
)
