"""zamba2-2.7b [hybrid] — Mamba2 blocks + one shared attention+MLP block
invoked every 6th layer. [arXiv:2411.15242; hf]

The shared block's parameters are a single copy reused across all 9
invocations (per-invocation LoRA deltas from the reference model are omitted;
DESIGN.md §7). ssm_state=64, d_inner=2*d, headdim=64 -> 80 ssm heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    cycle=("mamba",) * 5 + ("shared_attn",),
    ssm_state_dim=64,
    ssm_heads=80,
    ssm_expand=2,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=12,
    d_model=32,
    num_heads=4,
    num_kv_heads=4,
    head_dim=8,
    d_ff=64,
    vocab_size=128,
    cycle=("mamba",) * 5 + ("shared_attn",),
    ssm_state_dim=8,
    ssm_heads=4,
    ssm_expand=2,
    attn_chunk=16,
    xent_chunk=32,
)
