"""Locality-sensitive hash families used by STORM sketches (port of
``repro.core.lsh``).

* **SRP** (signed random projections): collision probability
  ``(1 - acos(cos(x, y)) / pi) ** p`` for ``p`` concatenated hyperplanes.
* The **asymmetric inner-product hash**: data ``[z, 0, sqrt(1 - |z|^2)]``,
  queries ``[q, sqrt(1 - |q|^2), 0]``, then SRP.
* **PRP** (paired random projections): hash both ``+z`` and ``-z``.

Codes are ``int32`` in ``[0, 2**p)``. Hash families come from a
``torch.Generator`` or, for parity with the JAX package, from projections
carried across by :mod:`repro_torch.interop`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, randn, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Parameters of ``R`` independent p-plane SRP hash functions.

    Attributes:
      projections: ``(R, p, dim)`` float32 hyperplane normals.
    """

    projections: Tensor

    @property
    def rows(self) -> int:
        return self.projections.shape[0]

    @property
    def planes(self) -> int:
        return self.projections.shape[1]

    @property
    def dim(self) -> int:
        return self.projections.shape[2]

    @property
    def buckets(self) -> int:
        return 1 << self.planes


def init_srp(
    gen: torch.Generator, rows: int, planes: int, dim: int,
    orthogonal: bool = False, device: DeviceLike = None,
) -> LSHParams:
    """Draw ``rows`` independent p-plane SRP hash functions from ``gen``.

    ``orthogonal=True`` orthogonalizes each plane index across rows in blocks
    of ``dim`` (Haar blocks via QR), as ``repro.core.lsh.init_srp`` does.
    """
    dev = resolve_device(device)
    if not orthogonal:
        return LSHParams(projections=randn((rows, planes, dim), gen, dev))
    n_blocks = -(-rows // dim)
    g = randn((planes, n_blocks, dim, dim), gen, dev)
    q, _ = torch.linalg.qr(g)
    w = q.reshape(planes, n_blocks * dim, dim)[:, :rows]  # (p, R, d)
    return LSHParams(projections=w.transpose(0, 1).contiguous())


def _bit_weights(planes: int, device) -> Tensor:
    return 2 ** torch.arange(planes, dtype=torch.int32, device=device)


def srp_codes(params: LSHParams, x: Tensor) -> Tensor:
    """Hash ``x: (..., dim)`` with every row's SRP function -> ``(..., R)`` int32."""
    r, p, d = params.projections.shape
    w = params.projections.reshape(r * p, d)
    proj = torch.einsum("...d,kd->...k", x.to(torch.float32), w)
    bits = (proj.reshape(x.shape[:-1] + (r, p)) > 0).to(torch.int32)
    return (bits * _bit_weights(p, x.device)).sum(-1, dtype=torch.int32)


def _norm_pad(v: Tensor) -> Tensor:
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(1.0 - sq, min=0.0))


def augment_data(z: Tensor) -> Tensor:
    """``z -> [z, 0, sqrt(1 - |z|^2)]`` (residual clipped at 0)."""
    pad = _norm_pad(z)
    return torch.cat([z, torch.zeros_like(pad), pad], dim=-1)


def augment_query(q: Tensor) -> Tensor:
    """``q -> [q, sqrt(1 - |q|^2), 0]``."""
    pad = _norm_pad(q)
    return torch.cat([q, pad, torch.zeros_like(pad)], dim=-1)


def _quantile(x: Tensor, q: float) -> Tensor:
    """Linear-interpolation quantile of a 1-D tensor (``jnp.quantile``'s rule).

    Goes through ``torch.sort``: ``torch.quantile`` refuses inputs above
    2^24 elements, and streams exceed that.
    """
    s = torch.sort(x.reshape(-1)).values
    pos = q * (s.numel() - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, s.numel() - 1)
    return torch.lerp(s[lo], s[hi], pos - lo)


def scale_to_unit_ball(
    z: Tensor, slack: float = 1.05, quantile: float = 0.9
) -> Tuple[Tensor, Tensor]:
    """Scale rows by a high quantile of their norms and clip the tail onto
    the unit sphere. Returns ``(scaled, scale)``."""
    norms = torch.linalg.vector_norm(z, dim=-1)
    c = _quantile(norms, quantile) * slack + 1e-12
    zs = z / c
    nrm = torch.linalg.vector_norm(zs, dim=-1, keepdim=True)
    return zs / torch.clamp(nrm, min=1.0), c


def normalize_query(q: Tensor) -> Tensor:
    """Scale a query onto the unit sphere (zeros of ``<q, z>`` unchanged)."""
    nrm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(nrm, min=1e-12)


def srp_collision_prob(x: Tensor, y: Tensor, planes: int) -> Tensor:
    """P[SRP codes collide] for the symmetric (angular) hash."""
    cos = torch.sum(x * y, dim=-1) / (
        torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
        + 1e-12
    )
    cos = torch.clamp(cos, -1.0, 1.0)
    return (1.0 - torch.arccos(cos) / math.pi) ** planes


def ip_collision_prob(inner: Tensor, planes: int) -> Tensor:
    """P[collision] of the asymmetric inner-product hash, ``inner in [-1, 1]``."""
    inner = torch.clamp(inner, -1.0, 1.0)
    return (1.0 - torch.arccos(inner) / math.pi) ** planes


def prp_codes(params: LSHParams, z: Tensor) -> Tuple[Tensor, Tensor]:
    """Paired codes ``(codes(aug(z)), codes(aug(-z)))``, each ``(..., R)``."""
    return srp_codes(params, augment_data(z)), srp_codes(params, augment_data(-z))


def query_codes(params: LSHParams, q: Tensor) -> Tensor:
    """Codes for a query vector (normalized then asymmetrically augmented)."""
    return srp_codes(params, augment_query(normalize_query(q)))


def pair_codes(codes_a: Tensor, codes_b: Tensor, buckets_b: int) -> Tensor:
    """Injective code pairing (LSH composition, Theorem 1)."""
    return codes_a * buckets_b + codes_b


def empirical_collision_rate(params: LSHParams, x: Tensor, y: Tensor,
                             planes: int) -> Tensor:
    """Fraction of hash rows on which ``x`` and ``y`` collide (test helper).

    The hits are counted exactly and scaled by the fp32 reciprocal of R, as
    XLA lowers the reference's ``jnp.mean``, so the two agree bit for bit.
    """
    del planes  # implied by params; kept for symmetry with the analytic fns
    hits = (srp_codes(params, x) == srp_codes(params, y)).sum(
        -1, dtype=torch.int64).to(torch.float32)
    rows = params.projections.shape[0]
    return hits * float(np.float32(1.0) / np.float32(rows))
