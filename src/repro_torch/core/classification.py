"""STORM max-margin linear classification (port of
``repro.core.classification``, paper section 4.2, Theorem 3).

The loss ``phi(t) = 2^p (1 - acos(-t)/pi)^p`` with ``t = y <theta, x>`` is the
collision probability of the asymmetric inner-product hash applied to
``-y x``; inserting ``-y_i x_i`` (scaled into the unit ball, then
asymmetrically augmented) makes the sketch query at ``theta`` an estimator of
the mean margin loss. On the card (the default) the sketch is one
``hash_histogram`` launch and every DFO step one ``sketch_query`` launch;
:func:`fit_many` trains ``S`` tenants on one ``sketch_query_banked`` launch
per step.

Draws: ``gen`` draws the hash family, then the fit's draws in
``core.erm``'s order (``theta0`` noise first: the margin spec has
``init_noise``); each can be passed in instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core import dfo, erm, fleet, losses, lsh, sketch as sketch_lib
from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device

Tensor = torch.Tensor

# The registered surrogate this driver adapts (core.losses registry).
_SPEC = losses.MARGIN_CLASSIFICATION


@dataclasses.dataclass(frozen=True)
class StormClassifierConfig:
    rows: int = 100
    planes: int = 1               # the paper uses p=1 for the 2D demo
    batch: int = 512              # insert batch of the scan engine
    norm_slack: float = 1.05
    count_dtype: str = "int32"
    engine: str = "auto"          # insert/query path: scan | kernel | auto
    init_scale: float = 0.01      # theta0 noise radius (breaks sign symmetry)
    restarts: int = 1             # F: fleet size (one fused query serves all)
    restart_select: str = "best"  # best | average
    restart_basin_tol: float = 0.05
    restart_sigma_spread: float = 2.0
    restart_lr_spread: float = 2.0
    restart_init_scale: float = 0.3
    refine_steps: int = 0         # optional quadratic polish passes
    refine_radius: float = 0.3
    dfo: dfo.DFOConfig = dataclasses.field(
        default_factory=lambda: dfo.DFOConfig(
            steps=300, num_queries=8, sigma=0.5, learning_rate=1.0, decay=0.995
        )
    )


class FittedClassifier(NamedTuple):
    theta: Tensor
    sketch: sketch_lib.Sketch
    params: lsh.LSHParams
    losses: Tensor
    fleet_losses: Optional[Tensor] = None  # (F,) final sketch loss per member

    def decision(self, x: Tensor) -> Tensor:
        return x @ self.theta

    def predict(self, x: Tensor) -> Tensor:
        return torch.sign(self.decision(x))

    def accuracy(self, x: Tensor, y: Tensor) -> Tensor:
        return torch.mean((self.predict(x) == y).to(torch.float32))


def make_margin_loss_fn(
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    planes: int,
    engine: str = "auto",
):
    """Batched Theorem 3 margin-loss closure: ``2^p`` times the single-sided
    RACE estimate, with the kernel weight layout hoisted once per fit."""
    return erm.sketch_loss_fn(sk, params, paired=False, scale=2.0 ** planes,
                              engine=engine)


def _fit_kwargs(config: StormClassifierConfig) -> dict:
    return dict(dfo_config=config.dfo,
                fleet_config=fleet.config_from_restarts(config),
                restarts=config.restarts, engine=config.engine,
                refine_steps=config.refine_steps,
                refine_radius=config.refine_radius,
                init_scale=config.init_scale)


def _sketch(params, x, y, config, dev) -> sketch_lib.Sketch:
    return erm.sketch_surrogate(
        _SPEC, params, x.to(dev, torch.float32), y.to(dev, torch.float32),
        norm_slack=config.norm_slack, batch=config.batch,
        dtype=sketch_lib.counter_dtype(config.count_dtype),
        engine=config.engine, device=dev)


def fit(
    gen: Optional[torch.Generator],
    x: Tensor,
    y: Tensor,
    config: Optional[StormClassifierConfig] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedClassifier:
    """Train a linear hyperplane classifier from a STORM sketch.

    Args:
      gen: ``torch.Generator`` for the hash family and the DFO draws
        (``None``: seed 0 on the run's device).
      x: ``(n, d)`` features; y: ``(n,)`` labels in ``{-1, +1}``.
      config: hyperparameters. No zero guard rides in the selection: the
        decision rule is scale-free, so ``theta = 0`` is no fallback.
      params / directions / refine_samples / theta0_noise: a hash family
        and draws to use instead of drawing them (see ``erm.fit``).
      device: ``None`` runs on the card and raises without one; pass
        ``"cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    config = config or StormClassifierConfig()
    fleet.validate_select(config.restart_select)
    gen = gen if gen is not None else make_generator(0, dev)
    if params is None:
        params = lsh.init_srp(gen, config.rows, config.planes,
                              x.shape[-1] + 2, device=dev)
    sk = _sketch(params, x, y, config, dev)
    res = erm.fit(_SPEC, sk, params, generator=gen, directions=directions,
                  refine_samples=refine_samples, theta0_noise=theta0_noise,
                  device=dev, **_fit_kwargs(config))
    return FittedClassifier(theta=res.theta, sketch=sk, params=params,
                            losses=res.losses, fleet_losses=res.fleet_losses)


class FittedClassifierMany(NamedTuple):
    """``S`` per-tenant max-margin classifiers from one banked fleet."""

    theta: Tensor          # (S, d)
    bank: sketch_lib.SketchBank
    params: lsh.LSHParams
    losses: Tensor         # (S, steps)
    fleet_losses: Tensor   # (S, F)

    @property
    def tenants(self) -> int:
        return self.theta.shape[0]

    def select(self, i: int) -> FittedClassifier:
        """Tenant ``i`` as a standalone :class:`FittedClassifier`."""
        return FittedClassifier(
            theta=self.theta[i], sketch=self.bank.select(i),
            params=self.params, losses=self.losses[i],
            fleet_losses=self.fleet_losses[i],
        )

    def decision(self, x: Tensor) -> Tensor:
        """Per-tenant decision values for ``x: (S, n, d)`` -> ``(S, n)``."""
        return torch.einsum("snd,sd->sn", x, self.theta)

    def predict(self, x: Tensor) -> Tensor:
        return torch.sign(self.decision(x))

    def accuracy(self, x: Tensor, y: Tensor) -> Tensor:
        return torch.mean((self.predict(x) == y).to(torch.float32), dim=-1)


def fit_many(
    gen: Optional[torch.Generator],
    x: Union[Tensor, Sequence[Tensor]],
    y: Union[Tensor, Sequence[Tensor]],
    config: Optional[StormClassifierConfig] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedClassifierMany:
    """Train ``S`` per-tenant classifiers on one banked query stream.

    Each tenant's ``-y x`` stream is sketched by ``erm.sketch_surrogate``
    under ONE shared hash family, ``bank_of`` stacks the sketches, and an
    ``S*F``-member fleet advances on one fused banked query per DFO step.
    ``S = 1`` is :func:`fit` bit for bit.

    Args:
      x: ``(S, n, d)`` stacked features or a sequence of ``(n_s, d)``.
      y: ``(S, n)`` stacked labels or a matching sequence.
      directions / refine_samples / theta0_noise: all tenants' draws (see
        ``erm.fit_many``).
    """
    dev = resolve_device(device)
    config = config or StormClassifierConfig()
    fleet.validate_select(config.restart_select)
    gen = gen if gen is not None else make_generator(0, dev)
    xs, ys = erm.tenant_lists(x, y)
    if params is None:
        params = lsh.init_srp(gen, config.rows, config.planes,
                              xs[0].shape[-1] + 2, device=dev)
    bank = sketch_lib.bank_of([_sketch(params, xt, yt, config, dev)
                               for xt, yt in zip(xs, ys)])
    res = erm.fit_many(_SPEC, bank, params, generator=gen,
                       directions=directions, refine_samples=refine_samples,
                       theta0_noise=theta0_noise, device=dev,
                       **_fit_kwargs(config))
    return FittedClassifierMany(theta=res.theta, bank=bank, params=params,
                                losses=res.losses,
                                fleet_losses=res.fleet_losses)
