"""The ERM spine: one config -> sketch -> fleet -> select pipeline (port of
``repro.core.erm``).

A loss is a registered :class:`~.losses.Surrogate` spec; :func:`fit` trains
it against one frozen sketch and :func:`fit_many` trains ``S`` tenants
against one :class:`~.sketch.SketchBank` with one fused banked query per DFO
step. The regression and classification drivers (and their ``fit_many``)
are thin adapters over these two, and :func:`fit_surrogate` /
:func:`fit_surrogate_many` drive any registered loss from data. Only this
module and ``core.fleet`` call ``fleet.make_loss_fn`` and
``fleet.run_fleet``; everything else goes through :func:`sketch_loss_fn` and
:func:`run_fleet`.

Draws: tenant ``t`` draws from ``fleet.tenant_key(generator, t)`` (tenant 0
from the generator itself), in a fixed order: the ``theta0`` noise of specs
with ``init_noise`` (``(dim,)`` standard normals), the member inits
``(F - 1, dim)``, the sphere directions ``(steps, F, k, dim)``, then one
``(F, m, dim)`` block of refine samples per pass. Every draw can be passed
in instead (parity runs replay the JAX draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import dfo, fleet, losses, lsh, sketch as sketch_lib
from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import randn, resolve_device

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
    member_map: Optional[Tensor] = None,
    transform: Optional[Callable[[Tensor], Tensor]] = None,
) -> Callable[[Tensor], Tensor]:
    """The batched sketch-loss closure (see ``fleet.make_loss_fn``)."""
    return fleet.make_loss_fn(sk, params, paired=paired, scale=scale, l2=l2,
                              engine=engine, d=d, member_map=member_map,
                              transform=transform)


run_fleet = fleet.run_fleet


def surrogate_loss_fn(
    spec: SpecLike,
    sk,
    params: lsh.LSHParams,
    l2: float = 0.0,
    engine: str = "auto",
    member_map: Optional[Tensor] = None,
) -> Callable[[Tensor], Tensor]:
    """Loss closure for a registered surrogate (``sk`` a sketch, or a bank
    with ``member_map``); the ridge covers the first ``dim - pad`` iterate
    coordinates."""
    spec = resolve(spec)
    return sketch_loss_fn(
        sk, params, paired=spec.paired, scale=spec.scale(params.planes),
        l2=l2, engine=engine, d=params.dim - 2 - spec.pad,
        member_map=member_map, transform=spec.transform,
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


class ERMFitMany(NamedTuple):
    """Per-tenant iterate-space results of a banked fit."""

    theta: Tensor          # (S, dim)
    losses: Tensor         # (S, steps)
    fleet_losses: Tensor   # (S, F)


def _projection(spec: losses.Surrogate):
    return (dfo.pin_last_coordinate(spec.pin_last)
            if spec.pin_last is not None else None)


def _seed_tenant(
    spec: losses.Surrogate,
    generator: Optional[torch.Generator],
    t: int,
    f: int,
    dim: int,
    dfo_config: dfo.DFOConfig,
    fleet_config: fleet.FleetConfig,
    refine_steps: int,
    init_scale: float,
    device: torch.device,
    theta0_noise: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """Tenant ``t``'s fleet and draws, in the module's draw order.

    Returns ``(theta0 (F, dim), sigmas (F,), lrs (F,), directions (steps,
    F, k, dim), refine_samples (passes, F, m, dim))``; draws passed in are
    used as they are, the others come from ``tenant_key(generator, t)``.
    """
    gen = None if generator is None else fleet.tenant_key(generator, t)

    def need(what: str) -> torch.Generator:
        if gen is None:
            raise ValueError(f"{spec.name}: pass {what} or a generator")
        return gen

    theta0 = None
    if spec.init_noise:
        if theta0_noise is None:
            theta0_noise = randn((dim,), need("theta0_noise"), device)
        theta0 = init_scale * theta0_noise.to(device)
    if f > 1 and inits is None:
        inits = randn((f - 1, dim), need("inits"), device)
    theta0, sigmas, lrs = fleet.seed_fleet(f, dim, dfo_config, fleet_config,
                                           theta0=theta0, inits=inits,
                                           device=device)
    if directions is None:
        directions = dfo.sphere_directions(need("directions"),
                                           dfo_config.steps, f,
                                           dfo_config.num_queries, dim,
                                           device)
    if refine_samples is None:
        m = dfo.refine_sample_count(dim)
        refine_samples = torch.stack(
            [randn((f, m, dim), need("refine_samples"), device)
             for _ in range(refine_steps)]) if refine_steps else None
    return theta0, sigmas, lrs, directions, refine_samples


def _on_device(sk, params: lsh.LSHParams, dev: torch.device):
    """A sketch or bank and its hash family moved to ``dev``."""
    sk = type(sk)(counts=sk.counts.to(dev), n=sk.n.to(dev))
    return sk, lsh.LSHParams(projections=params.projections.to(dev))


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
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> ERMFit:
    """Train one surrogate against one frozen sketch (Algorithm 2, generic).

    Loss closure from the spec, restart-fleet seeding, optimize-then-refine,
    fused selection with the spec's guard and projection. The sketch and
    hash family move to ``device`` (``None``: the card, raising without
    one), where the run lives. Draws not passed in come from ``generator``
    (module docstring): ``theta0_noise (dim,)``, ``inits (F - 1, dim)``,
    ``directions (steps, F, k, dim)``, ``refine_samples (passes, F, m,
    dim)``.
    """
    spec = resolve(spec)
    f = max(1, restarts)
    fc = fleet_config or fleet.FleetConfig()
    fleet.validate_select(fc.select)
    dim = params.dim - 2
    dev = resolve_device(device)
    sk, params = _on_device(sk, params, dev)
    rs = spec.refine_steps if refine_steps is None else refine_steps

    loss_fn = surrogate_loss_fn(spec, sk, params, l2=l2, engine=engine)
    proj = _projection(spec)
    theta0, sigmas, lrs, dirs, refine = _seed_tenant(
        spec, generator, 0, f, dim, dfo_config, fc, rs, init_scale, dev,
        theta0_noise=theta0_noise, inits=inits, directions=directions,
        refine_samples=refine_samples)
    result = run_fleet(
        loss_fn, theta0, dfo_config, project=proj, sigma=sigmas,
        learning_rate=lrs, refine_steps=rs, refine_radius=refine_radius,
        directions=dirs, refine_samples=refine,
    )
    guard = (proj(torch.zeros((dim,), dtype=torch.float32, device=dev))
             if spec.zero_guard else None)
    theta, trace, fleet_vals = fleet.select_theta(
        loss_fn, result.theta, result.losses, select=fc.select,
        basin_tol=fc.basin_tol, guard=guard, project=proj,
    )
    return ERMFit(theta=theta, losses=trace, fleet_losses=fleet_vals)


def fit_many(
    spec: SpecLike,
    bank: sketch_lib.SketchBank,
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
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> ERMFitMany:
    """Train ``S`` tenants' surrogates against one bank.

    An ``S*F``-member fleet advances on one fused banked query of
    ``S*F*(2k+1)`` points per DFO step; per-tenant selection runs all
    ``S*(F + guard)`` candidates through one more fused call. ``S = 1`` is
    :func:`fit` bit for bit: the same tenant-0 draws, and the 1-sketch bank
    runs the lone-sketch program. Draws passed in cover all tenants,
    member-major: ``theta0_noise (S, dim)``, ``inits (S, F - 1, dim)``,
    ``directions (steps, S*F, k, dim)``, ``refine_samples (passes, S*F, m,
    dim)``.
    """
    spec = resolve(spec)
    s = bank.size
    f = max(1, restarts)
    fc = fleet_config or fleet.FleetConfig()
    fleet.validate_select(fc.select)
    dim = params.dim - 2
    dev = resolve_device(device)
    bank, params = _on_device(bank, params, dev)
    rs = spec.refine_steps if refine_steps is None else refine_steps

    tenants = torch.arange(s, dtype=torch.int32, device=dev)
    members = tenants[:, None].expand(s, f).reshape(-1)  # tenant of member
    loss_fn = surrogate_loss_fn(spec, bank, params, l2=l2, engine=engine,
                                member_map=members)
    proj = _projection(spec)
    block = lambda a, t: None if a is None else a[:, t * f:(t + 1) * f]
    parts = [
        _seed_tenant(
            spec, generator, t, f, dim, dfo_config, fc, rs, init_scale, dev,
            theta0_noise=None if theta0_noise is None else theta0_noise[t],
            inits=None if inits is None else inits[t],
            directions=block(directions, t),
            refine_samples=block(refine_samples, t))
        for t in range(s)
    ]
    theta0, sigmas, lrs = (torch.cat([p[i] for p in parts]) for i in range(3))
    dirs = torch.cat([p[3] for p in parts], dim=1)
    refine = torch.cat([p[4] for p in parts], dim=1) if rs else None
    result = run_fleet(
        loss_fn, theta0, dfo_config, project=proj, sigma=sigmas,
        learning_rate=lrs, refine_steps=rs, refine_radius=refine_radius,
        directions=dirs, refine_samples=refine,
    )
    sel_loss = surrogate_loss_fn(spec, bank, params, l2=l2, engine=engine,
                                 member_map=tenants)
    guard = (proj(torch.zeros((dim,), dtype=torch.float32, device=dev))
             if spec.zero_guard else None)
    theta, trace, fleet_vals = fleet.select_theta_many(
        sel_loss, result.theta.reshape(s, f, dim),
        result.losses.reshape(s, f, -1), select=fc.select,
        basin_tol=fc.basin_tol, guard=guard, project=proj,
    )
    return ERMFitMany(theta=theta, losses=trace, fleet_losses=fleet_vals)


# ---------------------------------------------------------------------------
# End-to-end drivers: data -> sketch -> fit, any registered surrogate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ERMConfig:
    """Shared hyperparameters of the generic end-to-end drivers; the per-loss
    policy lives in the spec."""

    rows: int = 2048              # R repetitions
    planes: int = 4               # p
    batch: int = 512              # insert batch of the scan engine
    norm_slack: float = 1.05      # unit-ball scaling slack
    count_dtype: str = "int32"
    orthogonal: bool = False      # structured-orthogonal SRP
    engine: str = "auto"          # insert/query path: scan | kernel | auto
    l2: float = 0.0               # ridge on the DFO objective
    init_scale: float = 0.01      # theta0 noise radius (init_noise specs)
    refine_steps: Optional[int] = None  # None -> the spec's default
    refine_radius: float = 0.3
    restarts: int = 1             # F: fleet size
    restart_select: str = "best"
    restart_basin_tol: float = 0.05
    restart_sigma_spread: float = 2.0
    restart_lr_spread: float = 2.0
    restart_init_scale: float = 0.3
    dfo: dfo.DFOConfig = dataclasses.field(
        default_factory=lambda: dfo.DFOConfig(
            steps=300, num_queries=8, sigma=0.5, learning_rate=1.0,
            decay=0.995,
        )
    )


class SurrogateFit(NamedTuple):
    """End-to-end fit of a registered surrogate (iterate space)."""

    spec: losses.Surrogate
    theta: Tensor                 # (dim,) = (d + spec.pad,)
    sketch: sketch_lib.Sketch
    params: lsh.LSHParams
    losses: Tensor
    fleet_losses: Tensor

    def objective(self, z: Tensor) -> Tensor:
        """Analytic oracle at the fitted iterate over pre-scaled rows."""
        return self.spec.objective(self.theta, z, self.params.planes)


class SurrogateFitMany(NamedTuple):
    """End-to-end banked fit of a registered surrogate over S tenants."""

    spec: losses.Surrogate
    theta: Tensor                 # (S, dim)
    bank: sketch_lib.SketchBank
    params: lsh.LSHParams
    losses: Tensor                # (S, steps)
    fleet_losses: Tensor          # (S, F)

    @property
    def tenants(self) -> int:
        return self.theta.shape[0]


def _fit_kwargs(config: ERMConfig) -> dict:
    return dict(dfo_config=config.dfo,
                fleet_config=fleet.config_from_restarts(config),
                restarts=config.restarts, l2=config.l2, engine=config.engine,
                refine_steps=config.refine_steps,
                refine_radius=config.refine_radius,
                init_scale=config.init_scale)


def _sketch_kwargs(config) -> dict:
    return dict(norm_slack=config.norm_slack, batch=config.batch,
                dtype=sketch_lib.counter_dtype(config.count_dtype),
                engine=config.engine)


def fit_surrogate(
    spec: SpecLike,
    generator: Optional[torch.Generator],
    x: Tensor,
    y: Optional[Tensor] = None,
    config: Optional[ERMConfig] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> SurrogateFit:
    """Data -> sketch -> fit for any registered surrogate.

    ``generator`` (``None``: seed 0 on the run's device) draws the hash
    family, then the fit's draws; ``params`` and the draws can be passed in
    instead. Runs on ``device`` (``None``: the card, raising without one).
    """
    spec = resolve(spec)
    config = config or ERMConfig()
    fleet.validate_select(config.restart_select)
    dev = resolve_device(device)
    gen = generator if generator is not None else make_generator(0, dev)
    x = x.to(dev, torch.float32)
    y = None if y is None else y.to(dev, torch.float32)
    if params is None:
        params = lsh.init_srp(gen, config.rows, config.planes,
                              x.shape[-1] + spec.pad + 2,
                              orthogonal=config.orthogonal, device=dev)
    sk = sketch_surrogate(spec, params, x, y, device=dev,
                          **_sketch_kwargs(config))
    res = fit(spec, sk, params, generator=gen, directions=directions,
              refine_samples=refine_samples, inits=inits,
              theta0_noise=theta0_noise, device=dev, **_fit_kwargs(config))
    return SurrogateFit(spec=spec, theta=res.theta, sketch=sk, params=params,
                        losses=res.losses, fleet_losses=res.fleet_losses)


def tenant_lists(x, y) -> Tuple[list, list]:
    """Per-tenant ``x`` and ``y`` lists of a stacked ``(S, n, d)`` block or a
    sequence of ``(n_s, d)`` tensors (``y`` may be ``None``)."""
    xs = list(x)
    ys = [None] * len(xs) if y is None else list(y)
    if not xs or len(ys) != len(xs):
        raise ValueError(f"need matching non-empty x/y stacks; got "
                         f"{len(xs)} and {len(ys)} tenants")
    return xs, ys


def fit_surrogate_many(
    spec: SpecLike,
    generator: Optional[torch.Generator],
    x: Union[Tensor, Sequence[Tensor]],
    y=None,
    config: Optional[ERMConfig] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    theta0_noise: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> SurrogateFitMany:
    """Banked end-to-end driver: ``S`` tenants' data under ONE hash family.

    ``x`` is a sequence of ``(n_s, d)`` tensors or an ``(S, n, d)`` stack;
    ``y`` matches, or is ``None`` for unsupervised specs. Each tenant is
    sketched by :func:`sketch_surrogate`, then :func:`~.sketch.bank_of`
    stacks them. ``S = 1`` is :func:`fit_surrogate` bit for bit.
    """
    spec = resolve(spec)
    config = config or ERMConfig()
    fleet.validate_select(config.restart_select)
    dev = resolve_device(device)
    gen = generator if generator is not None else make_generator(0, dev)
    xs, ys = tenant_lists(x, y)
    if params is None:
        params = lsh.init_srp(gen, config.rows, config.planes,
                              xs[0].shape[-1] + spec.pad + 2,
                              orthogonal=config.orthogonal, device=dev)
    bank = sketch_lib.bank_of([
        sketch_surrogate(spec, params, xt.to(dev, torch.float32),
                         None if yt is None else yt.to(dev, torch.float32),
                         device=dev, **_sketch_kwargs(config))
        for xt, yt in zip(xs, ys)
    ])
    res = fit_many(spec, bank, params, generator=gen, directions=directions,
                   refine_samples=refine_samples, inits=inits,
                   theta0_noise=theta0_noise, device=dev,
                   **_fit_kwargs(config))
    return SurrogateFitMany(spec=spec, theta=res.theta, bank=bank,
                            params=params, losses=res.losses,
                            fleet_losses=res.fleet_losses)
