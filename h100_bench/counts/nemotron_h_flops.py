"""Model FLOPs of NemotronH's tapped forward (``model`` in
``configs/nemotron-3-nano-30b-a3b-taps.json``), in the architecture's least
form.

Per token, for every matrix product, 2 FLOPs per weight it multiplies: a
Mamba2 layer's input and down products, an MoE layer's router, its
``experts_per_token`` active experts (up and down) and its shared expert,
an attention layer's four projections; a Mamba2 layer's depthwise conv, 2
per weight; per Mamba2 head the recurrent form of the SSM: the state update
``S = a S + (dt B) x^T`` (``3 N P + N``), the readout ``y = C S``
(``2 N P``) and the skip ``y + D x`` (``2 P``). Per sequence, causal
attention over the positions each query sees: ``4 head_dim`` per (query,
key) pair a head, ``S (S + 1) / 2`` pairs; and the unembedding of the last
position only (``2 d V``), as the taps' target reads it. Norms,
activations, the routing's sort and softmax, and the embedding gather
count 0.
"""

from __future__ import annotations


def mamba_terms(m: dict) -> dict:
    """A Mamba2 layer's FLOPs a token: ``products``, ``conv`` and ``ssm``
    (the recurrent form)."""
    d, h, p = m["d_model"], m["ssm_heads"], m["ssm_head_dim"]
    n, w = m["ssm_state_dim"], m["ssm_conv_width"]
    di, bc = h * p, 2 * m["ssm_groups"] * n
    return {"products": 2.0 * d * (2 * di + bc + h) + 2.0 * di * d,
            "conv": 2.0 * w * (di + bc),
            "ssm": h * (3.0 * n * p + n + 2.0 * n * p + 2.0 * p)}


def moe_terms(m: dict) -> dict:
    """An MoE layer's FLOPs a token: ``router``, ``experts`` (the active
    ones) and ``shared``."""
    d = m["d_model"]
    return {"router": 2.0 * d * m["num_experts"],
            "experts": 4.0 * m["experts_per_token"] * d * m["d_ff"],
            "shared": 4.0 * d * m["moe_shared_d_ff"]}


def per_token_attn(m: dict) -> float:
    d, hq, hk, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return 2.0 * d * (hq * hd + 2 * hk * hd) + 2.0 * hq * hd * d


def per_sequence(m: dict, seq_len: int) -> float:
    """FLOPs of one sequence of ``seq_len`` tokens through the tapped
    forward."""
    kinds = m["layer_pattern"]
    n_attn = kinds.count("attn_only")
    per_token = (kinds.count("mamba") * sum(mamba_terms(m).values())
                 + kinds.count("moe") * sum(moe_terms(m).values())
                 + n_attn * per_token_attn(m))
    pairs = seq_len * (seq_len + 1) / 2.0
    attn = n_attn * m["num_heads"] * 4.0 * m["head_dim"] * pairs
    return seq_len * per_token + attn + 2.0 * m["d_model"] * m["vocab_size"]
