"""Analytic surrogate losses and the surrogate registry (port of
``repro.core.losses``: ``prp_regression``, ``margin_classification``,
``logistic`` and ``kmeans``).

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


def classification_surrogate(margin: Tensor, planes: int) -> Tensor:
    """Theorem 3 margin loss ``phi(t) = 2^p (1 - acos(-t)/pi)^p``, ``t = y<theta, x>``."""
    return (2.0 ** planes) * _f(-margin) ** planes


def classification_empirical_risk(theta: Tensor, x: Tensor, y: Tensor,
                                  planes: int) -> Tensor:
    """Mean classification surrogate; ``y in {-1, +1}``; data pre-scaled."""
    th = theta / torch.clamp(torch.linalg.vector_norm(theta), min=1e-12)
    return torch.mean(classification_surrogate(y * (x @ th), planes))


def l2_empirical_risk(theta: Tensor, x: Tensor, y: Tensor) -> Tensor:
    return torch.mean((x @ theta - y) ** 2)


def hinge_empirical_risk(theta: Tensor, x: Tensor, y: Tensor) -> Tensor:
    return torch.mean(torch.clamp(1.0 - y * (x @ theta), min=0.0))


def surrogate_slope_at(inner: float, planes: int) -> Tensor:
    """``|dg/d<a,b>|`` at a given inner product: the paper's Fig. 3(b).

    Autograd of :func:`prp_surrogate`; not finite (NaN) at ``+-1``, where
    ``acos`` has an infinite slope, as in the reference.
    """
    t = torch.tensor(float(inner), dtype=torch.float32, requires_grad=True)
    (grad,) = torch.autograd.grad(prp_surrogate(t, planes), t)
    return grad.abs()


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


def _pow2_scale(planes: int) -> float:
    return 2.0 ** planes


def _neg_scale(planes: int) -> float:
    del planes
    return -1.0


def _encode_regression(x: Tensor, y: Optional[Tensor]) -> Tensor:
    """PRP regression rows: ``[x, y]`` (homogeneous target column)."""
    return torch.cat([x, y[:, None]], dim=-1)


def _encode_margin(x: Tensor, y: Optional[Tensor]) -> Tensor:
    """Theorem 3 premultiplication: ``-y x`` folds the label into the row."""
    return -y[:, None] * x


def _encode_points(x: Tensor, y: Optional[Tensor]) -> Tensor:
    """Unsupervised losses sketch the points themselves; ``y`` is ignored."""
    del y
    return x


#: Paper section 4.1 / Theorem 2: least squares through the paired PRP surrogate.
PRP_REGRESSION = register(Surrogate(
    name="prp_regression", paired=True, pad=1, pin_last=-1.0,
    zero_guard=True, init_noise=False, refine_steps=1,
    scale=_unit_scale, transform=None, encode=_encode_regression,
))

#: Paper section 4.2 / Theorem 3: max-margin classification, single-sided sketch.
MARGIN_CLASSIFICATION = register(Surrogate(
    name="margin_classification", paired=False, pad=0, pin_last=None,
    zero_guard=False, init_noise=True, refine_steps=0,
    scale=_pow2_scale, transform=None, encode=_encode_margin,
))

#: Exp-concave logistic-style objective: ``log1p`` of the scaled margin
#: estimate (monotone, so the same argmin as the margin surrogate).
LOGISTIC = register(Surrogate(
    name="logistic", paired=False, pad=0, pin_last=None,
    zero_guard=False, init_noise=True, refine_steps=0,
    scale=_pow2_scale, transform=torch.log1p, encode=_encode_margin,
))

#: Compressive k-means: minimizing the negated RACE density estimate of the
#: sketched point cloud drives ``theta`` to a density mode. Unsupervised.
KMEANS = register(Surrogate(
    name="kmeans", paired=False, pad=0, pin_last=None,
    zero_guard=False, init_noise=True, refine_steps=0,
    scale=_neg_scale, transform=None, encode=_encode_points,
))
