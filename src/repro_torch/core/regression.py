"""End-to-end STORM linear regression (port of ``repro.core.regression``,
paper section 4.1 + Algorithm 2).

Pipeline: standardize -> scale ``[x, y]`` into the unit ball -> one-pass PRP
sketch -> derivative-free minimization of the sketch-estimated surrogate ->
un-standardize ``theta``. On the card (the default) the sketch is one
``paired_hash_histogram`` launch and every DFO step one ``sketch_query``
launch. :func:`fit_many` fits ``S`` tenants under one hash family, every DFO
step one ``sketch_query_banked`` launch for all of them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core import dfo, erm, fleet, losses, lsh, sketch as sketch_lib
from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device

Tensor = torch.Tensor

# The registered surrogate this module fits (core.losses registry).
_SPEC = losses.PRP_REGRESSION


@dataclasses.dataclass(frozen=True)
class StormRegressorConfig:
    rows: int = 2048              # R repetitions
    planes: int = 4               # p: the paper finds p=4 the sharpest surrogate
    batch: int = 512              # insert batch of the scan engine
    standardize: bool = True
    norm_slack: float = 1.05      # unit-ball scaling slack (quantile-based)
    count_dtype: str = "int32"
    orthogonal: bool = False      # structured-orthogonal SRP
    engine: str = "auto"          # insert/query path: scan | kernel | auto
    l2: float = 0.0               # optional ridge on the DFO objective
    refine_steps: int = 1         # quadratic polish passes
    refine_radius: float = 0.3
    restarts: int = 1             # F: fleet size (one fused query serves all)
    restart_select: str = "best"  # best | average
    restart_basin_tol: float = 0.05
    restart_sigma_spread: float = 2.0
    restart_lr_spread: float = 2.0
    restart_init_scale: float = 0.3
    dfo: dfo.DFOConfig = dataclasses.field(
        default_factory=lambda: dfo.DFOConfig(
            steps=400, num_queries=8, sigma=0.5, sigma_decay=0.995,
            learning_rate=2.0, decay=0.995, average_tail=0.5,
        )
    )


class FittedRegressor(NamedTuple):
    theta: Tensor          # (d,) weights in the original feature space
    intercept: Tensor      # scalar
    theta_std: Tensor      # (d,) weights in standardized space
    sketch: sketch_lib.Sketch
    params: lsh.LSHParams
    losses: Tensor         # DFO loss trace of the selected fleet member
    x_mean: Tensor
    x_scale: Tensor
    y_mean: Tensor
    y_scale: Tensor
    fleet_losses: Optional[Tensor] = None  # (F,) final sketch loss per member

    def predict(self, x: Tensor) -> Tensor:
        return x @ self.theta + self.intercept

    def mse(self, x: Tensor, y: Tensor) -> Tensor:
        return torch.mean((self.predict(x) - y) ** 2)


def _standardize(x: Tensor, y: Tensor, enabled: bool):
    if enabled:
        # correction=0: the JAX reference's jnp.std has ddof 0.
        xm, xs = x.mean(0), torch.std(x, 0, correction=0) + 1e-8
        ym, ys = y.mean(), torch.std(y, correction=0) + 1e-8
    else:
        xm = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
        xs = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        ym = torch.zeros((), dtype=y.dtype, device=y.device)
        ys = torch.ones((), dtype=y.dtype, device=y.device)
    return (x - xm) / xs, (y - ym) / ys, xm, xs, ym, ys


scale_to_unit_ball = lsh.scale_to_unit_ball  # canonical home: core.lsh


def make_loss_fn(
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    l2: float = 0.0,
    engine: str = "auto",
    d: Optional[int] = None,
):
    """Regression's PRP sketch-loss closure: ``erm.sketch_loss_fn`` with
    ``paired=True`` (see ``fleet.make_loss_fn``)."""
    return erm.sketch_loss_fn(sk, params, paired=True, l2=l2, engine=engine,
                              d=d)


def seed_fleet(
    gen: Optional[torch.Generator],
    f: int,
    d: int,
    config: StormRegressorConfig,
    inits: Optional[Tensor] = None,
    device: DeviceLike = None,
):
    """Regression's restart-diversity schedule: ``fleet.seed_fleet`` over the
    ``(d + 1)``-dim homogeneous iterate with a zero baseline init.

    ``inits`` (``(F - 1, d + 1)`` standard normals) are drawn from ``gen``
    when omitted and ``F > 1``; the reference's per-member keys have no
    counterpart here (its draws cross as ``inits``).

    Returns:
      ``(theta0 (F, d+1), sigmas (F,), lrs (F,))``.
    """
    dev = resolve_device(device)
    return fleet.seed_fleet(f, d + 1, config.dfo,
                            fleet.config_from_restarts(config), inits=inits,
                            generator=gen, device=dev)


def fit(
    gen: Optional[torch.Generator],
    x: Tensor,
    y: Tensor,
    config: Optional[StormRegressorConfig] = None,
    prebuilt: Optional[tuple] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedRegressor:
    """Fit linear regression from a STORM sketch only.

    Args:
      gen: ``torch.Generator`` for the hash family and the DFO draws
        (``None``: seed 0 on the run's device).
      x: ``(n, d)`` features; y: ``(n,)`` targets. Both move to ``device``.
      config: hyperparameters.
      prebuilt: optionally ``(sketch, params, scale)`` built elsewhere (e.g.
        merged from shards); then ``x, y`` give only the standardization
        statistics and are never sketched.
      params: a hash family to use instead of drawing one (parity runs pass
        the JAX family through ``interop``).
      directions / refine_samples: DFO draws to replay (see ``erm.fit``).
      device: ``None`` runs on the card and raises without one; pass
        ``"cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    config = config or StormRegressorConfig()
    fleet.validate_select(config.restart_select)
    gen = gen if gen is not None else make_generator(0, dev)
    x = x.to(dev, torch.float32)
    y = y.to(dev, torch.float32)
    d = x.shape[-1]

    xs_, ys_, xm, xsc, ym, ysc = _standardize(x, y, config.standardize)

    if prebuilt is None:
        if params is None:
            params = lsh.init_srp(gen, config.rows, config.planes, d + 3,
                                  orthogonal=config.orthogonal, device=dev)
        sk = erm.sketch_surrogate(
            _SPEC, params, xs_, ys_, norm_slack=config.norm_slack,
            batch=config.batch,
            dtype=sketch_lib.counter_dtype(config.count_dtype),
            engine=config.engine, device=dev,
        )
    else:
        sk, params, _ = prebuilt

    res = erm.fit(
        _SPEC, sk, params, dfo_config=config.dfo,
        fleet_config=fleet.config_from_restarts(config),
        restarts=config.restarts, l2=config.l2, engine=config.engine,
        refine_steps=config.refine_steps, refine_radius=config.refine_radius,
        generator=gen, directions=directions, refine_samples=refine_samples,
        device=dev,
    )
    theta_std = res.theta[:d]

    # Un-standardize: y' = x' @ th with x' = (x - xm)/xs, y' = (y - ym)/ys.
    theta = ysc * theta_std / xsc
    intercept = ym - torch.dot(xm, theta)
    return FittedRegressor(
        theta=theta, intercept=intercept, theta_std=theta_std, sketch=sk,
        params=params, losses=res.losses, x_mean=xm, x_scale=xsc, y_mean=ym,
        y_scale=ysc, fleet_losses=res.fleet_losses,
    )


class FittedRegressorMany(NamedTuple):
    """``S`` per-tenant regressors trained in one banked fleet."""

    theta: Tensor          # (S, d) weights in each tenant's feature space
    intercept: Tensor      # (S,)
    theta_std: Tensor      # (S, d) standardized-space weights
    bank: sketch_lib.SketchBank
    params: lsh.LSHParams
    losses: Tensor         # (S, steps) trace of each tenant's selected member
    x_mean: Tensor         # (S, d)
    x_scale: Tensor        # (S, d)
    y_mean: Tensor         # (S,)
    y_scale: Tensor        # (S,)
    fleet_losses: Tensor   # (S, F) final sketch loss per tenant member

    @property
    def tenants(self) -> int:
        return self.theta.shape[0]

    def select(self, i: int) -> FittedRegressor:
        """Tenant ``i`` as a standalone :class:`FittedRegressor`."""
        return FittedRegressor(
            theta=self.theta[i], intercept=self.intercept[i],
            theta_std=self.theta_std[i], sketch=self.bank.select(i),
            params=self.params, losses=self.losses[i],
            x_mean=self.x_mean[i], x_scale=self.x_scale[i],
            y_mean=self.y_mean[i], y_scale=self.y_scale[i],
            fleet_losses=self.fleet_losses[i],
        )

    def predict(self, x: Tensor) -> Tensor:
        """Per-tenant predictions for ``x: (S, n, d)`` -> ``(S, n)``."""
        return (torch.einsum("snd,sd->sn", x, self.theta)
                + self.intercept[:, None])

    def mse(self, x: Tensor, y: Tensor) -> Tensor:
        return torch.mean((self.predict(x) - y) ** 2, dim=-1)


def fit_many(
    gen: Optional[torch.Generator],
    x: Union[Tensor, Sequence[Tensor]],
    y: Union[Tensor, Sequence[Tensor]],
    config: Optional[StormRegressorConfig] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedRegressorMany:
    """Fit ``S`` per-tenant regressions from one banked query stream.

    Each tenant runs :func:`fit`'s preprocessing (standardize, then
    ``erm.sketch_surrogate``) under ONE shared hash family; ``bank_of``
    stacks the sketches, and an ``S*F``-member fleet trains with one fused
    banked query per DFO step. ``S = 1`` is :func:`fit` bit for bit.

    Args:
      gen: as :func:`fit`; tenant ``t`` draws from ``fleet.tenant_key``.
      x: ``(S, n, d)`` stacked features, or a sequence of ``(n_s, d)``
        tensors (lengths may differ); y: the matching targets.
      params / directions / refine_samples: a hash family and all tenants'
        draws to use instead of drawing them (see ``erm.fit_many``).
      device: ``None`` runs on the card and raises without one.
    """
    dev = resolve_device(device)
    config = config or StormRegressorConfig()
    fleet.validate_select(config.restart_select)
    gen = gen if gen is not None else make_generator(0, dev)
    xs_list, ys_list = erm.tenant_lists(x, y)
    s = len(xs_list)
    d = xs_list[0].shape[-1]
    if params is None:
        params = lsh.init_srp(gen, config.rows, config.planes, d + 3,
                              orthogonal=config.orthogonal, device=dev)
    sketches, moments = [], []
    for xt, yt in zip(xs_list, ys_list):
        xs_, ys_, *m = _standardize(xt.to(dev, torch.float32),
                                    yt.to(dev, torch.float32),
                                    config.standardize)
        sketches.append(erm.sketch_surrogate(
            _SPEC, params, xs_, ys_, norm_slack=config.norm_slack,
            batch=config.batch,
            dtype=sketch_lib.counter_dtype(config.count_dtype),
            engine=config.engine, device=dev,
        ))
        moments.append(m)
    bank = sketch_lib.bank_of(sketches)

    res = erm.fit_many(
        _SPEC, bank, params, dfo_config=config.dfo,
        fleet_config=fleet.config_from_restarts(config),
        restarts=config.restarts, l2=config.l2, engine=config.engine,
        refine_steps=config.refine_steps, refine_radius=config.refine_radius,
        generator=gen, directions=directions, refine_samples=refine_samples,
        device=dev,
    )
    theta_std = res.theta[:, :d]
    xm, xsc, ym, ysc = (torch.stack([m[i] for m in moments])
                        for i in range(4))
    theta = ysc[:, None] * theta_std / xsc
    # One dot per tenant, as fit() does, so S = 1 repeats its intercept.
    intercept = torch.stack([ym[t] - torch.dot(xm[t], theta[t])
                             for t in range(s)])
    return FittedRegressorMany(
        theta=theta, intercept=intercept, theta_std=theta_std, bank=bank,
        params=params, losses=res.losses, x_mean=xm, x_scale=xsc, y_mean=ym,
        y_scale=ysc, fleet_losses=res.fleet_losses,
    )


def sketch_memory_bytes(config: StormRegressorConfig) -> int:
    """Size of the persistent state the edge device ships (counters only)."""
    itemsize = sketch_lib.counter_dtype(config.count_dtype).itemsize
    return config.rows * (1 << config.planes) * itemsize
