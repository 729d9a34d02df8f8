"""Shared neural-net layers: norms, rotary embeddings, the SwiGLU MLP, the
embedding tables and the chunked cross-entropy (port of
``repro.models.layers``).

Plain functions on tensors over parameter dicts. Matmul weights are stored
``(in, out)`` as in the reference, so every product is ``x @ W`` and no
weight is ever transposed per step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import randn

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``param_dtype`` / ``compute_dtype``) as torch's."""
    return _DTYPES[name]


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """``x / rms(x) * (1 + scale)``, computed in f32 and cast back to
    ``x``'s dtype (the scales start at zero)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dtype)


# --- rotary position embeddings --------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embeddings on split halves (not interleaved pairs).

    Args:
      x: ``(..., seq, heads, head_dim)``.
      positions: ``(..., seq)`` integer absolute positions.
    """
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    # A Python base: a tensor made from it would be a host-to-device copy,
    # which waits for the stream, twice a layer.
    freqs = torch.pow(float(theta), exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- SwiGLU MLP --------------------------------------------------------------


def mlp(params: Params, x: Tensor, compute_dtype: torch.dtype) -> Tensor:
    x = x.to(compute_dtype)
    gate = torch.nn.functional.silu(x @ params["gate"].to(compute_dtype))
    up = x @ params["up"].to(compute_dtype)
    return (gate * up) @ params["down"].to(compute_dtype)


# --- embeddings --------------------------------------------------------------


def embed(table: Tensor, tokens: Tensor, compute_dtype: torch.dtype) -> Tensor:
    return table[tokens.long()].to(compute_dtype)


def unembed(table: Tensor, x: Tensor, compute_dtype: torch.dtype) -> Tensor:
    """Logits = ``x @ table`` with ``table`` ``(d, vocab)`` (the embedding's
    transpose when tied)."""
    return x.to(compute_dtype) @ table.to(compute_dtype)


def normal(shape, scale: float, dtype: torch.dtype, gen: torch.Generator
           ) -> Tensor:
    """Scaled standard normals drawn in f32 on ``gen``'s device and cast to
    ``dtype`` at once (the reference's per-tensor init)."""
    return (randn(shape, gen) * scale).to(dtype)


# --- chunked softmax cross-entropy ------------------------------------------


def chunked_softmax_xent(x: Tensor, unembed_table: Tensor, labels: Tensor,
                         mask: Optional[Tensor] = None, chunk: int = 512
                         ) -> Tensor:
    """Mean next-token cross-entropy without the full-sequence logits.

    The ``(B, S, vocab)`` logits dominate activation memory at LM vocab
    sizes, so the loop takes ``chunk`` positions at a time: each chunk's
    logits come from the product in ``x``'s dtype, then are f32, as is the
    logsumexp. Autograd keeps one chunk's f32 logits per chunk. Labels are
    the next-token ids, already aligned by the caller.

    Args:
      x: ``(B, S, d)`` final hidden states.
      unembed_table: ``(d, vocab)``.
      labels: ``(B, S)`` integer target ids.
      mask: optional ``(B, S)`` {0, 1} loss mask.

    Returns:
      the f32 mean loss over unmasked positions (over ``max(count, 1)``).
    """
    b, s, _ = x.shape
    labels = labels.long()
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.to(torch.float32))
    c = min(chunk, s)
    pad = (-s) % c
    if pad:  # as the reference: zero rows, label 0, mask 0
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    table = unembed_table.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s + pad, c):
        li = labels[:, start:start + c]
        mi = mask[:, start:start + c]
        logits = (x[:, start:start + c] @ table).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None])[..., 0]
        total = total + ((lse - gold) * mi).sum()
        count = count + mi.sum()
    return total / torch.clamp(count, min=1.0)
