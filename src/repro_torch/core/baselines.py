"""Compressed-regression baselines (port of ``repro.core.baselines``; this
slice ports the exact OLS oracle)."""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class LinearFit(NamedTuple):
    theta: Tensor
    intercept: Tensor
    memory_bytes: int

    def predict(self, x: Tensor) -> Tensor:
        return x @ self.theta + self.intercept

    def mse(self, x: Tensor, y: Tensor) -> Tensor:
        return torch.mean((self.predict(x) - y) ** 2)


def _with_bias(x: Tensor) -> Tensor:
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                    device=x.device)], dim=-1)


def _solve(xb: Tensor, y: Tensor, memory_bytes: int, ridge: float = 1e-6
           ) -> LinearFit:
    d = xb.shape[-1]
    gram = xb.T @ xb + ridge * torch.eye(d, dtype=xb.dtype, device=xb.device)
    coef = torch.linalg.solve(gram, xb.T @ y)
    return LinearFit(theta=coef[:-1], intercept=coef[-1],
                     memory_bytes=memory_bytes)


def ols(x: Tensor, y: Tensor) -> LinearFit:
    """Exact least squares on the full dataset (the oracle)."""
    xb = _with_bias(x)
    return _solve(xb, y, memory_bytes=xb.numel() * 4 + y.numel() * 4)
