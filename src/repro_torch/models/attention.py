"""Attention: GQA with RoPE, qk-norm, QKV bias, sliding-window / local
masking, memory-bounded chunked softmax, one-token decode against a KV
cache and non-causal cross-attention onto frontend states (port of
``repro.models.attention``).

Sequence attention follows the reference's math: a loop over query chunks
with an online softmax over key/value chunks, so the ``(S, S)`` score matrix
never materializes, and windowed layers only look at the last ``span`` keys
before each query chunk. The scores and the accumulator are f32 (the
reference's ``preferred_element_type``; casting bf16 values to f32 is exact),
the probabilities are cast to the value dtype before the PV product. Decode
is a masked softmax over the cache: scores in the compute dtype, softmax in
f32, probabilities cast back before the PV product, as the reference does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import layers

Tensor = torch.Tensor
Params = Dict[str, Tensor]

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qkv_bias: bool,
                   qk_norm: bool, dtype: torch.dtype) -> Params:
    """Projection weights ``(in, out)``, drawn from ``gen`` on its device."""
    s = d ** -0.5
    dev = gen.device
    p = {
        "wq": layers.normal((d, num_heads * head_dim), s, dtype, gen),
        "wk": layers.normal((d, num_kv_heads * head_dim), s, dtype, gen),
        "wv": layers.normal((d, num_kv_heads * head_dim), s, dtype, gen),
        "wo": layers.normal((num_heads * head_dim, d),
                            (num_heads * head_dim) ** -0.5, dtype, gen),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
    if qk_norm:
        p["q_norm"] = torch.zeros((head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((head_dim,), dtype=dtype, device=dev)
    return p


def _project_qkv(params: Params, x: Tensor, positions: Tensor,
                 num_heads: int, num_kv_heads: int, head_dim: int,
                 rope_theta: float, compute_dtype: torch.dtype
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KH,hd), normed and RoPE'd."""
    b, s, _ = x.shape
    xc = x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xc @ params["wk"].to(compute_dtype)
    v = xc @ params["wv"].to(compute_dtype)
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if "q_norm" in params:
        # No eps argument: the reference's default 1e-6, not cfg.norm_eps.
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    if rope_theta > 0:
        q = layers.rope(q, positions, rope_theta)
        k = layers.rope(k, positions, rope_theta)
    return q, k, v


def _online_softmax_scan(
    q: Tensor,            # (B, c, KH, G, D): one query chunk
    k_full: Tensor,       # (B, T, KH, D): the sliced key stream
    v_full: Tensor,       # (B, T, KH, D)
    q_pos: Tensor,        # (c,) absolute query positions
    k_pos0: int,          # absolute position of k_full[:, 0]
    *,
    chunk: int,
    causal: bool,
    window: Optional[int],
    valid_len: Optional[int],
) -> Tensor:
    """Streaming softmax over key/value chunks. Returns ``(B, c, KH, G, D)``.

    A key outside the mask scores ``NEG_INF``; once any key of a row is
    valid, the correction ``exp(m - m_new)`` wipes whatever a fully masked
    chunk before it accumulated, so padded keys never keep weight.
    """
    b, t, kh, d = k_full.shape
    g, c = q.shape[3], q.shape[1]
    scale = d ** -0.5
    qf = q.to(torch.float32)
    dev = q.device
    m = torch.full((b, kh, g, c), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, c), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, g, c, d), dtype=torch.float32, device=dev)
    steps = torch.arange(chunk, device=dev)
    for t_idx in range(t // chunk):
        kt = k_full[:, t_idx * chunk:(t_idx + 1) * chunk]
        vt = v_full[:, t_idx * chunk:(t_idx + 1) * chunk]
        k_pos = k_pos0 + t_idx * chunk + steps
        s_ = torch.einsum("bqhgd,bthd->bhgqt", qf,
                          kt.to(torch.float32)) * scale
        mask = torch.ones((c, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        if valid_len is not None:
            mask &= (k_pos[None, :] < valid_len) & (k_pos[None, :] >= 0)
        s_ = torch.where(mask, s_, NEG_INF)
        m_new = torch.maximum(m, s_.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s_ - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqt,bthd->bhgqd",
                          p.to(vt.dtype).to(torch.float32),
                          vt.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, c, KH, G, D)


def chunked_attention(
    q: Tensor,            # (B, S, H, D)
    k: Tensor,            # (B, T, KH, D)
    v: Tensor,            # (B, T, KH, D)
    *,
    chunk: int,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> Tensor:
    """Memory-bounded attention: a loop over query chunks, each streaming
    over key/value chunks.

    Queries and keys are zero-padded to whole chunks; padded keys sit past
    ``T`` and the mask drops them, padded queries are cut from the output.
    For windowed attention each query chunk reads only the ``span`` keys
    that can fall in its window, so the work is O(S * window).
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    c = min(chunk, s)
    s_pad = (-s) % c
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s_pad)) if s_pad else q
    n_q = qp.shape[1] // c

    ck = min(chunk, t)
    t_pad = (-t) % ck
    if t_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad))
    t_total = k.shape[1]
    span = (min(t_total, ((window + c - 1) // ck + 1) * ck)
            if window is not None else t_total)

    qb = qp.reshape(b, n_q, c, kh, g, d)
    steps = torch.arange(c, device=q.device)
    outs = []
    for i in range(n_q):
        start = (min(max(q_offset + (i + 1) * c - span, 0), t_total - span)
                 if window is not None else 0)
        outs.append(_online_softmax_scan(
            qb[:, i], k[:, start:start + span], v[:, start:start + span],
            q_offset + i * c + steps, start, chunk=ck, causal=causal,
            window=window, valid_len=t))
    out = torch.stack(outs, dim=1).reshape(b, n_q * c, h, d)
    return out[:, :s]


def apply_attention(
    params: Params,
    x: Tensor,
    positions: Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int],
    chunk: int,
    compute_dtype: torch.dtype,
) -> Tensor:
    """Full causal self-attention over a sequence (prefill)."""
    q, k, v = _project_qkv(params, x, positions, num_heads, num_kv_heads,
                           head_dim, rope_theta, compute_dtype)
    out = chunked_attention(q, k, v, chunk=chunk, causal=True, window=window)
    b, s = x.shape[:2]
    out = out.reshape(b, s, num_heads * head_dim)
    return out @ params["wo"].to(compute_dtype)


def cross_attention(
    params: Params,
    x: Tensor,            # (B, S, d) text stream
    kv_states: Tensor,    # (B, T, d) frontend-provided embeddings
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    chunk: int,
    compute_dtype: torch.dtype,
) -> Tensor:
    """Non-causal cross-attention onto stub image or frame embeddings:
    queries from ``x``, keys and values from ``kv_states``, no RoPE,
    ``q_norm``/``k_norm`` when the block has them."""
    b, s, _ = x.shape
    t = kv_states.shape[1]
    xc = x.to(compute_dtype)
    kvc = kv_states.to(compute_dtype)
    q = (xc @ params["wq"].to(compute_dtype)).reshape(b, s, num_heads,
                                                      head_dim)
    k = (kvc @ params["wk"].to(compute_dtype)).reshape(b, t, num_kv_heads,
                                                       head_dim)
    v = (kvc @ params["wv"].to(compute_dtype)).reshape(b, t, num_kv_heads,
                                                       head_dim)
    if "q_norm" in params:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    out = chunked_attention(q, k, v, chunk=chunk, causal=False, window=None)
    out = out.reshape(b, s, num_heads * head_dim)
    return out @ params["wo"].to(compute_dtype)


class KVCache(NamedTuple):
    """Decode cache in ``(B, KH, T, D)`` layout: the decode products read it
    without a per-step transpose."""

    k: Tensor
    v: Tensor


def decode_attention(
    params: Params,
    x: Tensor,            # (B, 1, d)
    cache: KVCache,
    pos: Tensor,          # (B,) per-lane index of the incoming token, or ()
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int],
    compute_dtype: torch.dtype,
) -> Tuple[Tensor, KVCache]:
    """One-token decode against a (possibly rolling) KV cache.

    ``pos`` per lane (continuous batching) scatters each lane's entry into
    its slot; a scalar ``pos`` writes one slot for every lane. For
    windowed layers with ``T <= window`` the cache is a ring: the new entry
    lands at ``pos % T`` and each slot's absolute position is reconstructed
    for the validity mask.
    """
    b = x.shape[0]
    t = cache.k.shape[2]
    pos = torch.as_tensor(pos, device=x.device)
    per_lane = pos.ndim > 0
    posb = pos.expand(b)[:, None]                                # (B, 1)
    q, k_new, v_new = _project_qkv(params, x, posb, num_heads, num_kv_heads,
                                   head_dim, rope_theta, compute_dtype)
    is_ring = window is not None and t <= window
    kn = k_new[:, 0].to(cache.k.dtype)[:, :, None, :]            # (B, KH, 1, D)
    vn = v_new[:, 0].to(cache.v.dtype)[:, :, None, :]
    slot = torch.clamp(pos % t if is_ring else pos, 0, t - 1)
    if per_lane:
        idx = slot.long()[:, None, None, None].expand(kn.shape)  # (B,KH,1,D)
        ck = cache.k.scatter(2, idx, kn)
        cv = cache.v.scatter(2, idx, vn)
    else:
        idx = slot.reshape(1).long()
        ck = cache.k.index_copy(2, idx, kn)
        cv = cache.v.index_copy(2, idx, vn)

    g = num_heads // num_kv_heads
    qg = q.reshape(b, 1, num_kv_heads, g, head_dim)
    s_ = torch.einsum("bqhgd,bhtd->bhgqt", qg, ck.to(compute_dtype)) * (
        head_dim ** -0.5)
    slots = torch.arange(t, device=x.device)[None, :]             # (1, T)
    if is_ring:
        # Slot s holds the absolute position p with p % T == s, p <= pos.
        abs_pos = posb - ((posb - slots) % t)
        valid = (abs_pos >= 0) & (abs_pos <= posb) & (posb - abs_pos < window)
    else:
        valid = slots <= posb
        if window is not None:
            valid &= posb - slots < window
    s_ = torch.where(valid[:, None, None, None, :], s_, NEG_INF)
    p = torch.softmax(s_.to(torch.float32), dim=-1)
    out = torch.einsum("bhgqt,bhtd->bqhgd", p.to(compute_dtype),
                       cv.to(compute_dtype))
    out = out.reshape(b, 1, num_heads * head_dim)
    return out @ params["wo"].to(compute_dtype), KVCache(ck, cv)
