"""STORM's paired insert and RACE query, in plain PyTorch.

A frozen statement of what the served counters and query estimates must be
(the STORM paper, arXiv:2006.14544, with the PRP insert). Hash family:
``projections (R, p, dim)``, ``dim = d + 2`` for ``d``-wide sketch-space
rows. A row ``z`` is hashed as ``[z, 0, pad]`` and ``[-z, 0, pad]`` with
``pad = sqrt(max(0, 1 - |z|^2))``; a query ``theta`` as ``[q, qpad, 0]``
with ``q = theta / max(|theta|, 1e-12)``. Plane ``j``'s bit of row ``r`` is
the sign of the projection. Every projection is accumulated feature by
feature in index order, a rounded product then a rounded sum, and the
negative side of a row is ``acc < 2 * pad * w_pad`` from the same
accumulator, so that a sign never rests on the order of a sum: the served
counters then have one right answer, and the comparison is exact.

``dtype`` is the precision of the hash: float32 as the configuration
states, bfloat16 for the control.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def kernel_layout(projections: Tensor) -> Tensor:
    """``(R, p, dim)`` -> ``(p, dim, R)``."""
    return projections.permute(1, 2, 0).contiguous()


def _project(x: Tensor, wj: Tensor, dtype) -> Tensor:
    acc = torch.zeros((x.shape[0], wj.shape[1]), dtype=dtype, device=x.device)
    for i in range(x.shape[1]):
        acc = acc + x[:, i:i + 1] * wj[i]
    return acc


def paired_codes(z: Tensor, w: Tensor, dtype=torch.float32
                 ) -> Tuple[Tensor, Tensor]:
    """``(codes of [z, 0, pad], codes of [-z, 0, pad])``, each ``(n, R)``
    int64, for ``z (n, d)`` and ``w (p, d + 2, R)``."""
    n, d = z.shape
    z = z.to(dtype)
    w = w.to(dtype)
    sq = torch.zeros((n, 1), dtype=dtype, device=z.device)
    for i in range(d):
        sq = sq + z[:, i:i + 1] * z[:, i:i + 1]
    pad = torch.sqrt(torch.clamp(1.0 - sq, min=0.0))
    pos = torch.zeros((n, w.shape[2]), dtype=torch.int64, device=z.device)
    neg = torch.zeros_like(pos)
    for j in range(w.shape[0]):
        acc = _project(z, w[j, :d], dtype) + pad * w[j, d + 1]
        pos |= (acc > 0).to(torch.int64) << j
        neg |= (acc < 2.0 * pad * w[j, d + 1]).to(torch.int64) << j
    return pos, neg


def weighted_counts(z: Tensor, w: Tensor, mult: Tensor, dtype=torch.float32,
                    chunk: int = 8192) -> Tensor:
    """``(K, R, 2^p)`` int64: row ``k`` is the paired histogram of ``z``'s
    rows, row ``i`` added ``mult[k, i]`` times.

    Per chunk of rows, one f32 product of the multiplicities with the rows'
    one-hot buckets (TF32 off): each partial sum is an integer below 2^24,
    so the product is exact, and the chunks add in int64.
    """
    k, n = mult.shape
    r, buckets = w.shape[2], 1 << w.shape[0]
    top = int(mult.max().item()) if mult.numel() else 0
    if top * 2 * chunk >= (1 << 24):
        chunk = max(1, (1 << 23) // max(top, 1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.zeros((k, r * buckets), dtype=torch.int64, device=z.device)
        for lo in range(0, n, chunk):
            m = mult[:, lo:lo + chunk].to(torch.float32)
            if not bool((m != 0).any()):
                continue
            pos, neg = paired_codes(z[lo:lo + chunk], w, dtype)
            onehot = torch.zeros((pos.shape[0], r, buckets), dtype=torch.float32,
                                 device=z.device)
            ones = torch.ones((pos.shape[0], r, 1), dtype=torch.float32,
                              device=z.device)
            onehot.scatter_add_(2, pos[..., None], ones)
            onehot.scatter_add_(2, neg[..., None], ones)
            out += (m @ onehot.view(pos.shape[0], -1)).to(torch.int64)
            del onehot, pos, neg
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.view(k, r, buckets)


def query_codes(theta: Tensor, w: Tensor, dtype=torch.float32) -> Tensor:
    """Codes ``(m, R)`` int64 of queries ``theta (m, d)``: normalized, then
    ``[q, sqrt(max(0, 1 - |q|^2)), 0]``, every feature projected in order."""
    nrm = torch.linalg.vector_norm(theta, dim=-1, keepdim=True)
    q = theta / torch.clamp(nrm, min=1e-12)
    pad = torch.sqrt(torch.clamp(1.0 - torch.sum(q * q, dim=-1, keepdim=True),
                                 min=0.0))
    x = torch.cat([q, pad, torch.zeros_like(pad)], dim=-1).to(dtype)
    w = w.to(dtype)
    codes = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.int64,
                        device=x.device)
    for j in range(w.shape[0]):
        codes |= (_project(x, w[j], dtype) > 0).to(torch.int64) << j
    return codes


def race_estimate(counts: Tensor, n: int, codes: Tensor) -> Tensor:
    """The paired RACE estimate at query codes ``(m, R)`` against one
    table ``counts (R, 2^p)`` of ``n`` rows: the gathered counts summed in
    int64, times the fp32 reciprocal of R, over ``2 max(n, 1)``."""
    r = counts.shape[0]
    rows = torch.arange(r, device=codes.device)
    total = counts[rows[None, :], codes].sum(-1).to(torch.float32)
    mean = total * float(np.float32(1.0) / np.float32(r))
    # A tensor divisor: on the card a Python scalar divisor is applied as a
    # product with its reciprocal, which is not the quotient bit for bit.
    denom = torch.clamp(torch.full_like(mean, float(np.float32(n))), min=1.0)
    return mean / (2.0 * denom)
