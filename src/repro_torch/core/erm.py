"""The ERM spine: one config -> sketch -> fleet -> select pipeline (port of the
lone-sketch half of ``repro.core.erm``).

A loss is a registered :class:`~.losses.Surrogate` spec; :func:`fit` trains
it against one frozen sketch. ``regression.fit`` is a thin adapter over it.
Only this module and ``core.fleet`` call ``fleet.make_loss_fn`` and
``fleet.run_fleet``; everything else goes through :func:`sketch_loss_fn` and
:func:`run_fleet`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import dfo, fleet, losses, lsh, sketch as sketch_lib
from repro_torch.device import DeviceLike, randn, resolve_device

Tensor = torch.Tensor

SpecLike = Union[str, losses.Surrogate]


def resolve(spec: SpecLike) -> losses.Surrogate:
    """Accept a registry name or a spec object everywhere."""
    return losses.get_surrogate(spec) if isinstance(spec, str) else spec


def sketch_loss_fn(
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    paired: bool = True,
    scale: float = 1.0,
    l2: float = 0.0,
    engine: str = "auto",
    d: Optional[int] = None,
    transform: Optional[Callable[[Tensor], Tensor]] = None,
) -> Callable[[Tensor], Tensor]:
    """The batched sketch-loss closure (see ``fleet.make_loss_fn``)."""
    return fleet.make_loss_fn(sk, params, paired=paired, scale=scale, l2=l2,
                              engine=engine, d=d, transform=transform)


run_fleet = fleet.run_fleet


def surrogate_loss_fn(
    spec: SpecLike,
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    l2: float = 0.0,
    engine: str = "auto",
) -> Callable[[Tensor], Tensor]:
    """Loss closure for a registered surrogate; the ridge covers the first
    ``dim - pad`` iterate coordinates."""
    spec = resolve(spec)
    return sketch_loss_fn(
        sk, params, paired=spec.paired, scale=spec.scale(params.planes),
        l2=l2, engine=engine, d=params.dim - 2 - spec.pad,
        transform=spec.transform,
    )


def sketch_surrogate(
    spec: SpecLike,
    params: lsh.LSHParams,
    x: Tensor,
    y: Optional[Tensor] = None,
    norm_slack: float = 1.05,
    batch: int = 512,
    dtype=torch.int32,
    engine: str = "auto",
    device: DeviceLike = None,
) -> sketch_lib.Sketch:
    """Sketch a dataset for a surrogate: encode -> unit ball -> insert.

    ``params.dim`` must be ``x.dim + spec.pad + 2``. Runs on ``device``
    (``None``: the card).
    """
    spec = resolve(spec)
    dev = resolve_device(device)
    x = x.to(dev)
    y = None if y is None else y.to(dev)
    z_scaled, _ = lsh.scale_to_unit_ball(spec.encode(x, y), norm_slack)
    if not spec.paired:
        z_scaled = lsh.augment_data(z_scaled)
    return sketch_lib.sketch_dataset(params, z_scaled, batch=batch,
                                     paired=spec.paired, dtype=dtype,
                                     engine=engine, device=dev)


class ERMFit(NamedTuple):
    """Iterate-space result of a generic fit (adapters un-standardize)."""

    theta: Tensor          # (dim,) with dim = params.dim - 2
    losses: Tensor         # DFO loss trace of the selected member
    fleet_losses: Tensor   # (F,) final sketch loss per member


def _projection(spec: losses.Surrogate):
    return (dfo.pin_last_coordinate(spec.pin_last)
            if spec.pin_last is not None else None)


def fit(
    spec: SpecLike,
    sk: sketch_lib.Sketch,
    params: lsh.LSHParams,
    dfo_config: dfo.DFOConfig,
    fleet_config: Optional[fleet.FleetConfig] = None,
    restarts: int = 1,
    l2: float = 0.0,
    engine: str = "auto",
    refine_steps: Optional[int] = None,
    refine_radius: float = 0.3,
    init_scale: float = 0.01,
    generator: Optional[torch.Generator] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> ERMFit:
    """Train one surrogate against one frozen sketch (Algorithm 2, generic).

    Loss closure from the spec, restart-fleet seeding, optimize-then-refine,
    fused selection with the spec's guard and projection. The sketch and
    hash family move to ``device`` (``None``: the card, raising without
    one), where the run lives. Draws not passed in come from ``generator``:
    ``directions (steps, F, k, dim)``, ``refine_samples (passes, F, m, dim)``
    and the member inits ``(F - 1, dim)``.
    """
    spec = resolve(spec)
    f = max(1, restarts)
    fc = fleet_config or fleet.FleetConfig()
    fleet.validate_select(fc.select)
    dim = params.dim - 2
    dev = resolve_device(device)
    sk = sketch_lib.Sketch(counts=sk.counts.to(dev), n=sk.n.to(dev))
    params = lsh.LSHParams(projections=params.projections.to(dev))
    rs = spec.refine_steps if refine_steps is None else refine_steps

    loss_fn = surrogate_loss_fn(spec, sk, params, l2=l2, engine=engine)
    proj = _projection(spec)
    theta0 = None
    if spec.init_noise:
        if generator is None:
            raise ValueError(f"{spec.name} draws its init; pass a generator")
        theta0 = init_scale * randn((dim,), generator, dev)
    theta0, sigmas, lrs = fleet.seed_fleet(f, dim, dfo_config, fc,
                                           theta0=theta0, inits=inits,
                                           generator=generator, device=dev)
    result = run_fleet(
        loss_fn, theta0, dfo_config, project=proj, sigma=sigmas,
        learning_rate=lrs, refine_steps=rs, refine_radius=refine_radius,
        directions=directions, refine_samples=refine_samples,
        generator=generator,
    )
    guard = (proj(torch.zeros((dim,), dtype=torch.float32, device=dev))
             if spec.zero_guard else None)
    theta, trace, fleet_vals = fleet.select_theta(
        loss_fn, result.theta, result.losses, select=fc.select,
        basin_tol=fc.basin_tol, guard=guard, project=proj,
    )
    return ERMFit(theta=theta, losses=trace, fleet_losses=fleet_vals)
