"""xlstm-1.3b [ssm] — mLSTM blocks. [arXiv:2405.04517; unverified]

Implemented with the sigmoid-gated mLSTM ("mLSTMsig", as in xLSTM-7B) in
chunked form; the 1.3B scale config is mLSTM-only (DESIGN.md §7).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    cycle=("mlstm",),
    ssm_heads=4,
    ssm_expand=2,
    rope_theta=0.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    num_layers=3,
    d_model=32,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=128,
    cycle=("mlstm",),
    ssm_heads=2,
    ssm_expand=2,
    rope_theta=0.0,
    attn_chunk=16,
    xent_chunk=32,
)
