"""The telemetry bridge's standardization of tapped features into sketch
rows, in plain PyTorch.

A tap's first flushed window fixes its moments: per-feature mean and
population std (+1e-8) of the features, the same of the targets, and the
unit-ball scale ``c``, the 0.9 quantile (linear interpolation) of the
standardized rows' norms times the slack, + 1e-12. Every row is then
``[(x - mean) / std, (y - y_mean) / y_std] / c``, clipped onto the unit
sphere when its norm passes 1.

``dtype`` is the arithmetic's precision: float32 as stated, bfloat16 for
the control.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def moments(feats: Tensor, targets: Tensor, slack: float,
            dtype=torch.float32) -> Tuple[Tensor, ...]:
    feats, targets = feats.to(dtype), targets.to(dtype)
    xm = feats.mean(0)
    xs = feats.std(0, correction=0) + 1e-8
    ym = targets.mean()
    ys = targets.std(correction=0) + 1e-8
    z = torch.cat([(feats - xm) / xs, ((targets - ym) / ys)[:, None]], dim=-1)
    norms = torch.sort(torch.linalg.vector_norm(z, dim=-1)).values
    pos = 0.9 * (norms.numel() - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, norms.numel() - 1)
    c = torch.lerp(norms[lo], norms[hi], pos - lo) * slack + 1e-12
    return xm, xs, ym, ys, c


def rows(feats: Tensor, targets: Tensor, mom: Tuple[Tensor, ...],
         dtype=torch.float32) -> Tensor:
    xm, xs, ym, ys, c = mom
    feats, targets = feats.to(dtype), targets.to(dtype)
    z = torch.cat([(feats - xm) / xs, ((targets - ym) / ys)[:, None]], dim=-1)
    z = z / c
    nrm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return (z / torch.clamp(nrm, min=1.0)).to(torch.float32)
