"""Architecture configuration for the LM stack (port of
``repro.models.config``, verbatim).

One frozen dataclass describes every assigned architecture (dense / ssm /
hybrid / moe / audio / vlm). Layer heterogeneity (gemma3's 5:1 local:global,
zamba2's mamba+shared-attention) is expressed as a *cycle*: a static tuple of
block kinds repeated ``num_layers / len(cycle)`` times, so scan-over-layers
stacks parameters per block kind with static shapes (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # Block cycle: kinds in {"attn", "local_attn", "mamba", "mlstm",
    # "shared_attn", "cross_attn"}. () means ("attn",) * num_layers.
    cycle: Tuple[str, ...] = ()

    # Attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # window for "attn" when set (SWA)
    local_window: int = 1024               # window for "local_attn"
    cross_attn_tokens: int = 4096          # stub image/frame token count

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM
    ssm_state_dim: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # Embeddings / misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embeddings_provided: bool = False  # audio/vlm stub frontends feed embeddings

    # Two-level (sqrt-L) remat: scan cycles in groups of this size; only the
    # group boundaries' residuals are saved, the inner cycles recompute.
    # None = flat scan (saves one carry per cycle).
    remat_group: Optional[int] = None

    # Sequence parallelism for linear-recurrence mixers (mLSTM): shard the
    # sequence over the `model` axis and run the recurrence as a cross-device
    # prefix scan (LASP-style; EXPERIMENTS.md §Perf hillclimb B).
    sequence_parallel: bool = False

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat_policy: str = "nothing"   # nothing | dots | none(=save everything)
    attn_chunk: int = 1024          # flash-attention block size
    xent_chunk: int = 512           # chunked softmax-xent block size

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.cycle:
            object.__setattr__(self, "cycle", ("attn",))
        assert self.num_layers % len(self.cycle) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"cycle length {len(self.cycle)}"
        )
        if self.num_heads and self.num_kv_heads:
            assert self.num_heads % self.num_kv_heads == 0

    @property
    def num_cycles(self) -> int:
        return self.num_layers // len(self.cycle)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        n = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        n += self.num_heads * hd * d  # wo
        if self.qkv_bias:
            n += self.num_heads * hd + 2 * self.num_kv_heads * hd
        if self.qk_norm:
            n += 2 * hd
        return n

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.is_moe:
            return d * self.num_experts + self.num_experts * 3 * d * self.d_ff
        if self.d_ff:
            return 3 * d * self.d_ff
        return 0

    def param_count(self) -> int:
        """Analytic parameter count — mirrors ``model.init_params`` exactly
        (used for the 6ND roofline MODEL_FLOPS)."""
        d = self.d_model
        di = d * self.ssm_expand
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += d  # final norm
        for kind in self.cycle:
            per = d  # pre_norm
            if kind in ("attn", "local_attn", "cross_attn"):
                per += self._attn_params()
                if self.d_ff or self.is_moe:
                    per += d + self._ffn_params()  # ffn_norm + ffn
            elif kind == "mlstm":
                per += d * (di // 2) * 2       # wq, wk
                per += d * di * 2              # wv, wo_gate
                per += d * 2 * self.ssm_heads + 2 * self.ssm_heads  # w_if, b_if
                per += di                      # out_norm
                per += di * d                  # wd
            elif kind == "mamba":
                per += d * (2 * di + 2 * self.ssm_state_dim + self.ssm_heads)
                per += self.ssm_conv_width * (di + 2 * self.ssm_state_dim)
                per += (di + 2 * self.ssm_state_dim)  # conv bias
                per += 3 * self.ssm_heads      # a_log, dt_bias, d_skip
                per += di                      # out_norm
                per += di * d                  # wd
            elif kind == "shared_attn":
                per = 0  # parameters shared; counted once below
            n += per * self.num_cycles
        if "shared_attn" in self.cycle:
            n += 2 * d + self._attn_params() + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only experts_per_token experts)."""
        if not self.is_moe:
            return self.param_count()
        per_layer_experts = self.num_experts * 3 * self.d_model * self.d_ff
        n_moe_layers = self.num_cycles * sum(
            1 for k in self.cycle if k in ("attn", "local_attn", "cross_attn")
        )
        inactive = per_layer_experts * (
            1.0 - self.experts_per_token / self.num_experts
        )
        return int(self.param_count() - n_moe_layers * inactive)
