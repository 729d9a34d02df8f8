"""Model FLOPs of the port's zamba2 tapped forward, in the architecture's
least form. They count the model as it runs (``model`` in
``configs/zamba2-2.7b-taps.json``), not Zamba2-2.7B as published, whose
shared block reads a stream twice as wide and which has 9 more Mamba2
layers (the file's ``departures``).

Per token, for every matrix product, 2 FLOPs per weight it multiplies (the
shared block counted at each of its calls); the depthwise conv, 2 per
weight; per Mamba2 head the recurrent form of the SSM: the state update
``S = a S + (dt B) x^T`` (``3 N P + N``), the readout ``y = C S``
(``2 N P``) and the skip ``y + D x`` (``2 P``). Per sequence, causal
attention over the positions each query sees: ``4 head_dim`` per (query,
key) pair a head (``QK^T`` and ``PV``), ``S (S + 1) / 2`` pairs; and the
unembedding of the last position only (``2 d V``), as the taps' target
reads it. Norms, activations, softmax and the embedding gather count 0.
"""

from __future__ import annotations


def mamba_terms(m: dict) -> dict:
    """A Mamba2 block's FLOPs a token: ``products`` (the input and down
    products), ``conv`` and ``ssm`` (the recurrent form)."""
    d = m["d_model"]
    di = d * m["ssm_expand"]
    n, h, w = m["ssm_state_dim"], m["ssm_heads"], m["ssm_conv_width"]
    p = di // h
    return {"products": 2.0 * d * (2 * di + 2 * n + h) + 2.0 * di * d,
            "conv": 2.0 * w * (di + 2 * n),
            "ssm": h * (3.0 * n * p + n + 2.0 * n * p + 2.0 * p)}


def per_token_mamba(m: dict) -> float:
    return sum(mamba_terms(m).values())


def per_token_shared(m: dict) -> float:
    d, hq, hk, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    proj = 2.0 * d * (hq * hd + 2 * hk * hd) + 2.0 * hq * hd * d
    return proj + 2.0 * 3 * d * m["d_ff"]


def per_sequence(m: dict, seq_len: int) -> float:
    """FLOPs of one sequence of ``seq_len`` tokens through the tapped
    forward."""
    cycles = m["num_layers"] // len(m["cycle"])
    n_mamba = cycles * m["cycle"].count("mamba")
    n_shared = cycles * m["cycle"].count("shared_attn")
    pairs = seq_len * (seq_len + 1) / 2.0
    attn = n_shared * m["num_heads"] * 4.0 * m["head_dim"] * pairs
    return (seq_len * (n_mamba * per_token_mamba(m)
                       + n_shared * per_token_shared(m))
            + attn + 2.0 * m["d_model"] * m["vocab_size"])
