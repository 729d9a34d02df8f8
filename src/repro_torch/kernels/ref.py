"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

The CPU tests run these, the kernel wrappers use them for CPU tensors, and
the card's kernels are compared with them. They repeat the kernels'
arithmetic exactly: every projection is accumulated feature by feature in
index order, a rounded multiply then a rounded add (no FMA), and the
negative side of the paired hash is ``acc < 2*pad*w_pad`` from the same
accumulator. So kernel and plain version compare bit for bit.

Weight layout (shared with the kernels): ``w: (p, d, R)``, plane-major.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sketch import mean_count, saturating_cast

Tensor = torch.Tensor

# Points per chunk are chosen so that one (chunk, R) fp32 tensor holds at most
# 2^24 cells (64 MB): a full stream's (n, R) codes would not fit.
_CHUNK_CELLS = 1 << 24


def _out_cast(counts32: Tensor, out_dtype: torch.dtype) -> Tensor:
    """The int32 histogram in ``out_dtype``, saturating for narrow dtypes."""
    if out_dtype.itemsize >= 4:
        return counts32.to(out_dtype)
    return saturating_cast(counts32, out_dtype)


def _project(x: Tensor, wj: Tensor) -> Tensor:
    """``x (n, d) . wj (d, R)`` accumulated feature by feature, no FMA."""
    acc = torch.zeros((x.shape[0], wj.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(x.shape[1]):
        acc = acc + x[:, i:i + 1] * wj[i]
    return acc


def srp_hash(x: Tensor, w: Tensor) -> Tensor:
    """SRP codes ``(n, R)`` int32 of ``x: (n, d)`` under ``w: (p, d, R)``."""
    x = x.to(torch.float32)
    codes = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.int32,
                        device=x.device)
    for j in range(w.shape[0]):
        codes |= (_project(x, w[j]) > 0).to(torch.int32) << j
    return codes


def _pad(z: Tensor) -> Tensor:
    """``sqrt(max(0, 1 - |z|^2))`` with the squares summed in index order."""
    sq = torch.zeros((z.shape[0], 1), dtype=torch.float32, device=z.device)
    for i in range(z.shape[1]):
        sq = sq + z[:, i:i + 1] * z[:, i:i + 1]
    return torch.sqrt(torch.clamp(1.0 - sq, min=0.0))


def paired_srp_hash(z: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """Antithetic PRP codes from one projection pass.

    ``aug(z) = [z, 0, pad]`` and ``aug(-z) = [-z, 0, pad]`` share the pad, so
    with ``acc = proj(aug(z))`` the negative side is ``2*pad*w_pad - acc``.
    ``acc`` sums the features of ``z`` in index order, then the pad term; the
    zero feature adds nothing and is skipped.

    Args:
      z: ``(n, d)`` pre-scaled points (NOT augmented).
      w: ``(p, d + 2, R)`` hyperplane normals of the augmented space.

    Returns:
      ``(codes_pos, codes_neg)``, each ``(n, R)`` int32.
    """
    n, d = z.shape
    if w.shape[1] != d + 2:
        raise ValueError(f"w has {w.shape[1]} features; z needs {d + 2}")
    z = z.to(torch.float32)
    pad = _pad(z)
    cpos = torch.zeros((n, w.shape[2]), dtype=torch.int32, device=z.device)
    cneg = torch.zeros_like(cpos)
    for j in range(w.shape[0]):
        acc = _project(z, w[j, :d]) + pad * w[j, d + 1]
        t2 = 2.0 * pad * w[j, d + 1]
        cpos |= (acc > 0).to(torch.int32) << j
        cneg |= (acc < t2).to(torch.int32) << j
    return cpos, cneg


def _masked_histogram(codes: Tensor, inc: Tensor, buckets: int) -> Tensor:
    """``(R, B)`` int32 histogram of ``(n, R)`` codes, point i adding ``inc[i]``."""
    r = codes.shape[1]
    offset = torch.arange(r, dtype=torch.int64, device=codes.device) * buckets
    flat = torch.zeros(r * buckets, dtype=torch.int32, device=codes.device)
    flat.index_add_(0, (offset + codes).reshape(-1),
                    inc[:, None].expand(codes.shape).reshape(-1))
    return flat.reshape(r, buckets)


def paired_hash_histogram(z: Tensor, w: Tensor, mask: Tensor,
                          out_dtype: torch.dtype = torch.int32) -> Tensor:
    """Fused antithetic PRP insert: ``(R, 2**p)`` counts in ``out_dtype``.

    Each point ``i`` adds ``int(mask[i])`` to two buckets of every row (its
    positive and negative codes); narrow dtypes saturate once at the end.
    """
    r = w.shape[2]
    buckets = 1 << w.shape[0]
    inc = mask.to(torch.int32)
    hist = torch.zeros((r, buckets), dtype=torch.int32, device=z.device)
    chunk = max(1, _CHUNK_CELLS // r)
    for start in range(0, z.shape[0], chunk):
        cpos, cneg = paired_srp_hash(z[start:start + chunk], w)
        m = inc[start:start + chunk]
        hist += _masked_histogram(cpos, m, buckets)
        hist += _masked_histogram(cneg, m, buckets)
    return _out_cast(hist, out_dtype)


def sketch_query(q: Tensor, w: Tensor, counts: Tensor) -> Tensor:
    """Batched RACE gather: ``(m,)`` fp32 mean over rows of ``counts[r, code_r]``.

    Args:
      q: ``(m, d)`` query vectors (already normalized and augmented).
      w: ``(p, d, R)`` hyperplane normals.
      counts: ``(R, 2**p)`` counters (int32, int16 or int8).
    """
    codes = srp_hash(q, w)
    rows = torch.arange(counts.shape[0], device=q.device)
    return mean_count(counts[rows[None, :], codes.long()])
