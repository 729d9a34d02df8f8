"""nemotron-3-nano-30b-a3b [hybrid moe] — NVIDIA Nemotron 3 Nano 30B-A3B:
52 layers in NemotronH's published ``hybrid_override_pattern`` (23 Mamba2,
23 MoE, 6 attention), each ``x + mixer(RMSNorm(x))``.
[hf: nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, modeling_nemotron_h.py]

Mamba2: 64 heads of 64 (d_inner 4096, not 2 x 2688), state 128, 8 B/C
groups, conv 4 with bias, gate then RMSNorm per group of 512. The SSD's
chunk is the published 128: on an H100 (700 W) the tapped forward of
8 x 2048 tokens takes 928 ms at 128, 986 at 256 and 1,417 at 1024.
MoE: 128 relu^2 experts of 1856, top 6 by a sigmoid router with a
score-correction bias, weights renormalized and scaled by 2.5, one relu^2
shared expert of 3712; the port's dropless path. Attention: GQA 32/2, head
128, no positional embedding (``rope_theta = 0``: NemotronH's attention has
no rotary module, and the published ``rope_theta`` goes unused). The JAX
package has no counterpart: it stays out of ``registry.ARCH_IDS``, which
mirrors the reference's.
"""

from repro_torch.models.config import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
_KINDS = {"M": "mamba", "E": "moe", "*": "attn_only"}


def layer_pattern(pattern: str):
    """NemotronH's pattern string as block kinds."""
    return tuple(_KINDS[c] for c in pattern)


CONFIG = ModelConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid",
    num_layers=52,
    d_model=2688,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=1856,
    vocab_size=131072,
    layer_pattern=layer_pattern(PATTERN),
    rope_theta=0.0,
    num_experts=128,
    experts_per_token=6,
    moe_routed_scale=2.5,
    moe_shared_d_ff=3712,
    ssm_state_dim=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_groups=8,
    ssm_group_norm=True,
    ssm_chunk=128,
    ssm_conv_width=4,
    norm_eps=1e-5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

# The same structure (every kind, the pattern's opening and close, groups,
# a shared expert) at smoke widths.
SMOKE = ModelConfig(
    name="nemotron-3-nano-30b-a3b-smoke",
    family="hybrid",
    num_layers=8,
    d_model=32,
    num_heads=4,
    num_kv_heads=2,
    head_dim=8,
    d_ff=16,
    vocab_size=128,
    layer_pattern=layer_pattern("MEM*EMEE"),
    rope_theta=0.0,
    num_experts=8,
    experts_per_token=3,
    moe_routed_scale=2.5,
    moe_shared_d_ff=24,
    ssm_state_dim=8,
    ssm_heads=8,
    ssm_head_dim=4,
    ssm_groups=4,
    ssm_group_norm=True,
    ssm_chunk=8,
    ssm_conv_width=4,
    norm_eps=1e-5,
    attn_chunk=16,
    xent_chunk=32,
)
