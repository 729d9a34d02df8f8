"""Architecture configuration for the LM stack (port of
``repro.models.config``, verbatim).

One frozen dataclass describes every assigned architecture (dense / ssm /
hybrid / moe / audio / vlm). Layer heterogeneity (gemma3's 5:1 local:global,
zamba2's mamba+shared-attention) is expressed as a *cycle*: a static tuple of
block kinds repeated ``num_layers / len(cycle)`` times, so scan-over-layers
stacks parameters per block kind with static shapes (DESIGN.md §5).

The port adds what the reference has no counterpart of: a non-periodic
``layer_pattern`` (one kind a layer, as NemotronH's
``hybrid_override_pattern``: the model is then one cycle of all its
layers, and taps name layers), the mixer-only kinds ``moe`` and
``attn_only``, grouped Mamba2 (``ssm_groups``, ``ssm_head_dim``, the
gate-then-group norm) and the dropless MoE of the ``moe`` kind. Attention
with no positional embedding (NoPE) is ``rope_theta = 0``.
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
    # "shared_attn", "cross_attn", "moe", "attn_only"}. () means ("attn",) *
    # num_layers. "moe" is an MoE-only block, "attn_only" attention with no
    # FFN after it.
    cycle: Tuple[str, ...] = ()
    # A per-layer pattern in place of a repeating cycle: num_layers kinds,
    # one a layer. The model is then one cycle of them, and taps, tallies
    # and ``tap_points`` index layers.
    layer_pattern: Tuple[str, ...] = ()

    # Attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0            # 0: no positional embedding
    sliding_window: Optional[int] = None   # window for "attn" when set (SWA)
    local_window: int = 1024               # window for "local_attn"
    cross_attn_tokens: int = 4096          # stub image/frame token count

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # The "moe" kind is NemotronH's MoE (``moe.dropless_moe``): every
    # (token, choice) row to its expert by grouped products, nothing
    # dropped; sigmoid scores, the top k of scores + a correction bias,
    # weights renormalized and scaled by moe_routed_scale; relu^2 experts
    # (down(relu(up x)^2)), plus a shared expert of moe_shared_d_ff when
    # > 0. Experts on attention kinds take the capacity path: softmax top-k,
    # SwiGLU experts.
    moe_routed_scale: float = 1.0
    moe_shared_d_ff: int = 0

    # SSM
    ssm_state_dim: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_head_dim: int = 0        # 0: d_inner = d_model * ssm_expand
    ssm_groups: int = 1          # Mamba2's B/C groups, each serving
                                 # ssm_heads / ssm_groups heads
    ssm_group_norm: bool = False  # gate, then RMSNorm per group (Mamba2's
                                  # norm_before_gate=False), eps norm_eps
    ssm_chunk: int = 0           # the SSD's chunk; 0: attn_chunk

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
        if self.layer_pattern:
            # dataclasses.replace passes the cycle set from the pattern.
            assert self.cycle in ((), tuple(self.layer_pattern)), (
                f"{self.name}: a cycle or a layer_pattern")
            assert len(self.layer_pattern) == self.num_layers, (
                f"{self.name}: layer_pattern has {len(self.layer_pattern)} "
                f"kinds for {self.num_layers} layers")
            object.__setattr__(self, "cycle", tuple(self.layer_pattern))
        if not self.cycle:
            object.__setattr__(self, "cycle", ("attn",))
        assert "moe" in self.cycle or not self.moe_shared_d_ff, (
            f"{self.name}: only the dropless MoE has a shared expert")
        if self.ssm_heads:
            assert self.ssm_heads % self.ssm_groups == 0
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
    def tap_points(self) -> int:
        """What a tap index counts: layers of a pattern, else cycles."""
        return self.num_layers if self.layer_pattern else self.num_cycles

    def tap_point(self, c: int, i: int) -> Optional[int]:
        """The tap index of the residual after block ``i`` of cycle ``c``:
        the layer of a pattern config, else the cycle at its last block;
        ``None`` inside a cycle."""
        if self.layer_pattern:
            return i
        return c if i == len(self.cycle) - 1 else None

    @property
    def ssm_inner(self) -> int:
        """Mamba2's and mLSTM's inner width."""
        if self.ssm_head_dim:
            return self.ssm_heads * self.ssm_head_dim
        return self.d_model * self.ssm_expand

    @property
    def ssm_chunk_len(self) -> int:
        return self.ssm_chunk or self.attn_chunk

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

    def _dropless_params(self) -> int:
        d, e = self.d_model, self.num_experts
        n = d * e + e                          # router, correction bias
        n += e * 2 * d * self.d_ff             # up, down
        return n + 2 * d * self.moe_shared_d_ff

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
        di = self.ssm_inner
        bc = 2 * self.ssm_groups * self.ssm_state_dim
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
            elif kind == "attn_only":
                per += self._attn_params()
            elif kind == "moe":
                per += self._dropless_params()
            elif kind == "mamba":
                per += d * (2 * di + bc + self.ssm_heads)
                per += self.ssm_conv_width * (di + bc)
                per += di + bc                 # conv bias
                per += 3 * self.ssm_heads      # a_log, dt_bias, d_skip
                per += di                      # out_norm
                per += di * d                  # wd
            elif kind == "shared_attn":
                per = 0  # parameters shared; counted once below
            n += per * self.num_cycles
        if "shared_attn" in self.cycle:
            n += 2 * d + self._attn_params() + 3 * d * self.d_ff
        return n

    def active_param_count(self, embedding: bool = True) -> int:
        """Active params per token (MoE: only experts_per_token experts);
        ``embedding=False`` leaves out the input table, which a token
        gathers a row of and multiplies nothing with."""
        n = self.param_count()
        if not embedding and not self.tie_embeddings:
            n -= self.vocab_size * self.d_model
        if not self.is_moe:
            return n
        if "moe" in self.cycle:
            per_layer_experts = self.num_experts * 2 * self.d_model * self.d_ff
            kinds = ("moe",)
        else:
            per_layer_experts = self.num_experts * 3 * self.d_model * self.d_ff
            kinds = ("attn", "local_attn", "cross_attn")
        n_moe_layers = self.num_cycles * sum(
            1 for k in self.cycle if k in kinds)
        inactive = per_layer_experts * (
            1.0 - self.experts_per_token / self.num_experts
        )
        return int(n - n_moe_layers * inactive)
