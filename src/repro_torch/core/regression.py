"""End-to-end STORM linear regression (port of ``repro.core.regression``,
paper section 4.1 + Algorithm 2).

Pipeline: standardize -> scale ``[x, y]`` into the unit ball -> one-pass PRP
sketch -> derivative-free minimization of the sketch-estimated surrogate ->
un-standardize ``theta``. On the card (the default) the sketch is one
``paired_hash_histogram`` launch and every DFO step one ``sketch_query``
launch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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


def sketch_memory_bytes(config: StormRegressorConfig) -> int:
    """Size of the persistent state the edge device ships (counters only)."""
    itemsize = sketch_lib.counter_dtype(config.count_dtype).itemsize
    return config.rows * (1 << config.planes) * itemsize
