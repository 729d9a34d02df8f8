"""Analytic surrogate losses and the surrogate registry (port of
``repro.core.losses``; this slice registers ``prp_regression`` only).

The closed-form expectations of the sketch queries are oracles for tests;
a :class:`Surrogate` spec is everything ``core.erm`` needs to train one loss
from counters, so the fits read the spec and never branch on its name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

Tensor = torch.Tensor


def _f(inner: Tensor) -> Tensor:
    """``f(a, b) = 1 - acos(<a, b>) / pi`` on the clipped inner product."""
    return 1.0 - torch.arccos(torch.clamp(inner, -1.0, 1.0)) / math.pi


def prp_surrogate(inner: Tensor, planes: int) -> Tensor:
    """PRP regression surrogate of Theorem 2, ``0.5 f^p + 0.5 f(-.)^p``."""
    return 0.5 * _f(inner) ** planes + 0.5 * _f(-inner) ** planes


def prp_empirical_risk(theta: Tensor, x: Tensor, y: Tensor, planes: int
                       ) -> Tensor:
    """Mean PRP surrogate over pre-scaled data, querying with ``[theta, -1]``."""
    tt = torch.cat([theta, -torch.ones((1,), dtype=theta.dtype,
                                       device=theta.device)])
    tt = tt / torch.clamp(torch.linalg.vector_norm(tt), min=1e-12)
    z = torch.cat([x, y[:, None]], dim=-1)
    return torch.mean(prp_surrogate(z @ tt, planes))


def l2_empirical_risk(theta: Tensor, x: Tensor, y: Tensor) -> Tensor:
    return torch.mean((x @ theta - y) ** 2)


@dataclasses.dataclass(frozen=True)
class Surrogate:
    """Everything ``core.erm`` needs to train one loss from counters.

    Attributes:
      name: registry key.
      paired: PRP paired sketch (estimator divides by ``2n``) vs single-sided.
      pad: homogeneous data coordinates beyond the features (regression
        appends the target: ``pad=1``).
      pin_last: if set, the iterate's last coordinate is projected to it.
      zero_guard: keep the projected zero as a selection candidate.
      init_noise: draw ``theta0 = init_scale * normal`` instead of zeros.
      refine_steps: default quadratic-polish passes.
      scale: ``planes -> float`` multiplier on the raw estimate.
      transform: optional monotone map of the scaled estimate.
      encode: ``(x, y) -> z`` rows to sketch (before unit-ball scaling).
    """

    name: str
    paired: bool
    pad: int
    pin_last: Optional[float]
    zero_guard: bool
    init_noise: bool
    refine_steps: int
    scale: Callable[[int], float]
    transform: Optional[Callable[[Tensor], Tensor]]
    encode: Callable[[Tensor, Optional[Tensor]], Tensor]

    def objective(self, theta: Tensor, z: Tensor, planes: int) -> Tensor:
        """Analytic sketch expectation at ``theta`` over pre-scaled rows ``z``."""
        th = theta / torch.clamp(torch.linalg.vector_norm(theta), min=1e-12)
        inner = z @ th
        per = (prp_surrogate(inner, planes) if self.paired
               else _f(inner) ** planes)
        est = torch.mean(per)
        sc = self.scale(planes)
        if sc != 1.0:
            est = sc * est
        if self.transform is not None:
            est = self.transform(est)
        return est


SURROGATES: Dict[str, Surrogate] = {}


def register(spec: Surrogate) -> Surrogate:
    """Add a spec to the registry (idempotent on identical re-registration)."""
    prior = SURROGATES.get(spec.name)
    if prior is not None and prior != spec:
        raise ValueError(f"surrogate {spec.name!r} already registered "
                         "with a different spec")
    SURROGATES[spec.name] = spec
    return spec


def get_surrogate(name: str) -> Surrogate:
    if name not in SURROGATES:
        raise ValueError(f"unknown surrogate {name!r}; registered: "
                         f"{sorted(SURROGATES)}")
    return SURROGATES[name]


def _unit_scale(planes: int) -> float:
    del planes
    return 1.0


def _encode_regression(x: Tensor, y: Optional[Tensor]) -> Tensor:
    """PRP regression rows: ``[x, y]`` (homogeneous target column)."""
    return torch.cat([x, y[:, None]], dim=-1)


#: Paper section 4.1 / Theorem 2: least squares through the paired PRP surrogate.
PRP_REGRESSION = register(Surrogate(
    name="prp_regression", paired=True, pad=1, pin_last=-1.0,
    zero_guard=True, init_noise=False, refine_steps=1,
    scale=_unit_scale, transform=None, encode=_encode_regression,
))
