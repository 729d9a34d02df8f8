"""Synthetic datasets (port of ``repro.data.datasets``).

The paper's UCI tables are not bundled, so regression problems are
generated to match them in (N, d), noise level and conditioning. Draws come
from a ``torch.Generator`` and land on its device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    noise: float
    condition: float  # ratio of largest/smallest feature covariance eigenvalue


UCI_MATCHED = (
    DatasetSpec("airfoil", n=1400, d=9, noise=0.3, condition=30.0),
    DatasetSpec("autos", n=159, d=26, noise=0.2, condition=100.0),
    DatasetSpec("parkinsons", n=5800, d=21, noise=0.4, condition=50.0),
)


def make_regression(
    gen: torch.Generator, n: int, d: int, noise: float = 0.1,
    condition: float = 10.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Linear-Gaussian regression with controlled covariance conditioning.

    Returns ``(x, y, theta_true)`` on ``gen``'s device;
    ``y = x @ theta_true + noise * eps``.
    """
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    eigs = torch.logspace(0.0, math.log10(condition), d, device=dev)
    eigs = eigs / eigs.mean()
    rot, _ = torch.linalg.qr(normal(d, d))
    x = (normal(n, d) * torch.sqrt(eigs)) @ rot.T
    theta = normal(d)
    y = x @ theta + noise * normal(n)
    return x, y, theta


def make_uci_matched(gen: torch.Generator, spec: DatasetSpec
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    return make_regression(gen, spec.n, spec.d, spec.noise, spec.condition)


def make_2d_regression(gen: torch.Generator, n: int = 2000,
                       noise: float = 0.1) -> Tuple[Tensor, Tensor, Tensor]:
    """The paper's Fig. 5 qualitative 2D regression dataset: ``x`` uniform
    in ``[-1, 1]``, ``y = 0.7 x + noise * eps``."""
    dev = gen.device
    x = torch.rand((n, 1), generator=gen, device=dev) * 2.0 - 1.0
    theta = torch.tensor([0.7], device=dev)
    y = x @ theta + noise * torch.randn((n,), generator=gen, device=dev)
    return x, y, theta


def make_classification(
    gen: torch.Generator, n: int = 2000, d: int = 2, margin: float = 0.5,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Two linearly separable Gaussian blobs; labels in {-1, +1}.

    Returns ``(x, y, theta_true)`` on ``gen``'s device; each point is pushed
    ``margin`` along the unit normal ``theta_true`` to its label's side.
    """
    dev = gen.device
    theta = torch.randn((d,), generator=gen, device=dev)
    theta = theta / torch.linalg.vector_norm(theta)
    x = torch.randn((n, d), generator=gen, device=dev)
    y = torch.sign(x @ theta)
    return x + margin * y[:, None] * theta, y, theta


def stream_batches(x: Tensor, y: Tensor, batch: int
                   ) -> Iterator[Tuple[Tensor, Tensor]]:
    """Streaming iterator: one pass, no shuffling (edge order)."""
    for i in range(0, x.shape[0], batch):
        yield x[i:i + batch], y[i:i + batch]
