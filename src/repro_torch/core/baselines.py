"""Compressed-regression baselines (port of ``repro.core.baselines``).

* uniform random sampling (keep ``m`` rows, solve OLS),
* leverage-score sampling (sample ``m`` rows by leverage, reweight, solve),
* Clarkson-Woodruff count-sketch-and-solve,
* streaming SVRG (the single-pass O(d)-memory competitor),
* the exact OLS oracle.

Each returns a fitted ``(theta, intercept)`` and its memory footprint in
bytes. The random draws (row indices, signs, the arrival permutation) come
from a ``torch.Generator`` unless passed in; parity runs pass the JAX draws.
These are plain PyTorch: none of them is a kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def uniform_sampling(gen: Optional[torch.Generator], x: Tensor, y: Tensor,
                     m: int, idx: Optional[Tensor] = None) -> LinearFit:
    """Keep ``m`` uniformly sampled rows (without replacement when
    ``m <= n``); memory = ``m (d + 1)`` float32."""
    n = x.shape[0]
    if idx is None:
        idx = (torch.randint(n, (m,), generator=gen, device=gen.device)
               if n < m else
               torch.randperm(n, generator=gen, device=gen.device)[:m])
    idx = idx.to(x.device)
    return _solve(_with_bias(x[idx]), y[idx],
                  memory_bytes=m * (x.shape[-1] + 1) * 4)


def leverage_scores(x: Tensor) -> Tensor:
    """Exact statistical leverage ``h_i = ||U_i||^2`` via thin QR."""
    q, _ = torch.linalg.qr(_with_bias(x))
    return torch.sum(q * q, dim=-1)


def leverage_sampling(gen: Optional[torch.Generator], x: Tensor, y: Tensor,
                      m: int, idx: Optional[Tensor] = None) -> LinearFit:
    """Sample ``m`` rows with probability by leverage (with replacement) and
    reweight each by ``1/sqrt(m p_i)``."""
    scores = leverage_scores(x)
    p = scores / torch.sum(scores)
    if idx is None:
        idx = torch.multinomial(p.to(gen.device), m, replacement=True,
                                generator=gen)
    idx = idx.to(x.device)
    w = 1.0 / torch.sqrt(m * p[idx] + 1e-12)
    return _solve(_with_bias(x[idx]) * w[:, None], y[idx] * w,
                  memory_bytes=m * (x.shape[-1] + 1) * 4)


def streaming_svrg(
    gen: Optional[torch.Generator],
    x: Tensor,
    y: Tensor,
    stages: int = 4,
    learning_rate: float = 0.05,
    order: Optional[Tensor] = None,
) -> LinearFit:
    """Single-pass streaming SVRG for least squares (Frostig et al. '15).

    The stream (in the arrival ``order``, a permutation drawn from ``gen``
    when omitted) splits into geometrically growing stages; each stage
    spends half its samples on the anchor gradient at ``w~`` and the other
    half on one variance-reduced step per sample. Every sample is read once
    and the working set is three ``(d + 1)``-vectors.
    """
    xb = _with_bias(x)
    n, d = xb.shape
    if order is None:
        order = torch.randperm(n, generator=gen, device=gen.device)
    order = order.to(x.device)
    weights = 2.0 ** torch.arange(stages, dtype=torch.float32)
    sizes = torch.floor(n * weights / torch.sum(weights)).to(torch.int32)
    w = torch.zeros((d,), dtype=xb.dtype, device=xb.device)
    start = 0
    for s in range(stages):
        size = int(sizes[s]) if s < stages - 1 else n - start
        if size < 2:
            continue
        sl = order[start:start + size]
        start += size
        half = size // 2
        anchor, inner = sl[:half], sl[half:]
        w_tilde = w
        xa = xb[anchor]
        g_anchor = xa.T @ (xa @ w_tilde - y[anchor]) / half
        for i in inner.tolist():
            xi, yi = xb[i], y[i]
            g = (xi * (xi @ w - yi) - xi * (xi @ w_tilde - yi)) + g_anchor
            w = w - learning_rate * g
    return LinearFit(theta=w[:-1], intercept=w[-1],
                     memory_bytes=3 * d * 4)  # w, w~, anchor gradient


def clarkson_woodruff(gen: Optional[torch.Generator], x: Tensor, y: Tensor,
                      m: int, rows: Optional[Tensor] = None,
                      signs: Optional[Tensor] = None) -> LinearFit:
    """CountSketch-and-solve: ``min_theta ||S(X theta - y)||`` (CW'09).

    ``S`` maps each row to one of ``m`` buckets (``rows``) with a random
    sign (``signs``); ``S X`` is a segment sum: one streaming pass,
    mergeable, O(m d) memory.
    """
    n = x.shape[0]
    if rows is None:
        rows = torch.randint(m, (n,), generator=gen, device=gen.device)
    if signs is None:
        signs = 2.0 * torch.randint(2, (n,), generator=gen,
                                    device=gen.device).to(x.dtype) - 1.0
    rows, signs = rows.to(x.device).long(), signs.to(x.device, x.dtype)
    xb = _with_bias(x) * signs[:, None]
    sx = torch.zeros((m, xb.shape[1]), dtype=x.dtype, device=x.device)
    sx.index_add_(0, rows, xb)
    sy = torch.zeros((m,), dtype=y.dtype, device=y.device)
    sy.index_add_(0, rows, y * signs)
    return _solve(sx, sy, memory_bytes=m * (x.shape[-1] + 2) * 4)
