"""Shared fleet machinery for the STORM fits (port of ``repro.core.fleet``).

* :func:`make_loss_fn`: the batched sketch-loss closure, over one sketch or
  a :class:`~.sketch.SketchBank`; the kernel weight layout
  ``(R, p, d) -> (p, d, R)`` is converted once per session.
* :func:`seed_fleet` / :func:`seed_fleet_many`: member 0 is the fit's
  baseline; members ``i >= 1`` draw random-ball inits and walk geometric
  sigma/lr ladders; banked fleets stack one block per tenant.
* :func:`run_fleet`: optimize, then refine with a halving radius.
* :func:`select_theta` / :func:`select_theta_many`: one fused query for all
  members (+ an optional zero guard), with the basin-average mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dfo, lsh, sketch as sketch_lib
from repro_torch.device import randn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Restart-diversity and selection knobs shared by all fits."""

    select: str = "best"          # best | average (basin average)
    basin_tol: float = 0.05       # average: keep members within (1+tol)*best
    sigma_spread: float = 2.0     # geometric sigma ladder across members
    lr_spread: float = 2.0        # geometric lr ladder (reverse-paired)
    init_scale: float = 0.3       # random-ball init radius, members >= 1


def config_from_restarts(config) -> FleetConfig:
    """A fit config's flat ``restart_*`` fields as a :class:`FleetConfig`."""
    return FleetConfig(
        select=config.restart_select,
        basin_tol=config.restart_basin_tol,
        sigma_spread=config.restart_sigma_spread,
        lr_spread=config.restart_lr_spread,
        init_scale=config.restart_init_scale,
    )


def validate_select(select: str) -> None:
    """Fail fast on a selection-mode typo, before minutes of training."""
    if select not in ("best", "average"):
        raise ValueError(f"unknown restart_select {select!r}; "
                         "use best | average")


def member_point_idx(member_map: Tensor, q: int) -> Tensor:
    """Per-point sketch index of a member-major ``(q, ...)`` batch.

    A batch of ``q`` points laid out as ``F`` contiguous per-member blocks
    routes row ``i`` to ``member_map[i // (q // F)]``.
    """
    f = member_map.shape[0]
    if q % f:
        raise ValueError(f"banked batch of {q} points is not member-major "
                         f"over {f} fleet members")
    # expand + reshape repeats each entry without reading the tensor back
    # (repeat_interleave may size its output on the host).
    return member_map[:, None].expand(f, q // f).reshape(q)


def make_loss_fn(
    sk,
    params: lsh.LSHParams,
    paired: bool = True,
    scale: float = 1.0,
    l2: float = 0.0,
    engine: str = "auto",
    d: Optional[int] = None,
    member_map: Optional[Tensor] = None,
    transform: Optional[Callable[[Tensor], Tensor]] = None,
) -> Callable[[Tensor], Tensor]:
    """Batched sketch-loss closure ``(q, dim) -> (q,)``.

    On the kernel engine the weight layout is converted here, once, and every
    call is one query launch on the card. ``d`` is the number of leading
    coordinates the ridge ``l2`` applies to (default ``params.dim - 3``).

    ``sk`` is a lone :class:`~.sketch.Sketch`, or a
    :class:`~.sketch.SketchBank` with ``member_map`` (``(F,)`` sketch index
    of each fleet member): the closure then takes member-major batches whose
    size is a multiple of ``F`` and routes each point to its member's table,
    one ``sketch_query_banked`` launch per call. A 1-sketch bank runs the
    lone-sketch program itself, so ``S = 1`` is the lone fit bit for bit.
    """
    d = params.dim - 3 if d is None else d
    banked = isinstance(sk, sketch_lib.SketchBank)
    if banked != (member_map is not None):
        raise ValueError("member_map must be given iff sk is a SketchBank")
    if banked and sk.size == 1:
        sk, banked, member_map = sk.select(0), False, None
    if banked:  # checked once here, so no query reads the index back
        lo, hi = (int(v) for v in torch.aminmax(member_map))
        if lo < 0 or hi >= sk.size:
            raise ValueError(f"member_map must lie in [0, {sk.size}); got "
                             f"{lo}..{hi}")
    idx_cache = {}

    def point_idx(thetas: Tensor) -> Tensor:
        if thetas.ndim != 2:
            raise ValueError("banked loss closures need (q, dim) batches")
        q = thetas.shape[0]
        if q not in idx_cache:  # one index per batch size of the session
            idx_cache[q] = member_point_idx(
                member_map.to(thetas.device, torch.int32), q)
        return idx_cache[q]

    if sketch_lib.resolve_engine(engine, sk.counts.device) == "kernel":
        from repro_torch.kernels import ops  # deferred: ops imports core

        w = ops.from_lsh_params(params)  # hoisted: once per session

        def estimate(thetas: Tensor) -> Tensor:
            idx = point_idx(thetas) if banked else None
            return ops.query_theta_with_weights(
                sk, w, thetas, paired=paired, sketch_idx=idx,
                index_checked=banked)
    else:

        def estimate(thetas: Tensor) -> Tensor:
            if banked:
                return sketch_lib.query_theta_banked(
                    sk, params, thetas, point_idx(thetas), paired=paired)
            return sketch_lib.query_theta(sk, params, thetas, paired=paired)

    def loss_fn(thetas: Tensor) -> Tensor:
        est = estimate(thetas)
        if scale != 1.0:
            est = scale * est
        if transform is not None:
            est = transform(est)
        if l2 > 0.0:
            est = est + l2 * torch.sum(thetas[..., :d] ** 2, dim=-1)
        return est

    return loss_fn


def seed_fleet(
    f: int,
    dim: int,
    base: dfo.DFOConfig,
    config: Optional[FleetConfig] = None,
    theta0: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Restart-diversity schedule.

    Member 0 starts at ``theta0`` (zeros when omitted) with the configured
    sigma/lr, so ``F = 1`` is the single-iterate fit. Members ``i >= 1``
    start at ``theta0 + init_scale * inits[i - 1]`` and walk geometric
    sigma/lr ladders (reverse-paired).

    Args:
      inits: ``(F - 1, dim)`` standard normals; drawn from ``generator``
        when omitted and ``F > 1``.

    Returns:
      ``(theta0 (F, dim), sigmas (F,), lrs (F,))``.
    """
    config = config or FleetConfig()
    base_theta = (torch.zeros((dim,), dtype=torch.float32, device=device)
                  if theta0 is None else theta0.to(torch.float32))
    dev = base_theta.device
    if f > 1 and inits is None:
        if generator is None:
            raise ValueError("seed_fleet needs inits or a generator for F > 1")
        inits = randn((f - 1, dim), generator, dev)
    sigmas, lrs, starts = [base.sigma], [base.learning_rate], [base_theta]
    for i in range(1, f):
        u = -1.0 + 2.0 * (i - 1) / max(1, f - 2) if f > 2 else 0.0
        sigmas.append(base.sigma * config.sigma_spread ** u)
        lrs.append(base.learning_rate * config.lr_spread ** (-u))
        starts.append(base_theta + config.init_scale * inits[i - 1].to(dev))
    as_f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return torch.stack(starts), as_f32(sigmas), as_f32(lrs)


def tenant_key(gen: torch.Generator, s: int) -> torch.Generator:
    """Per-tenant generator of a banked fit.

    Tenant 0 uses ``gen`` itself, so ``fit_many`` with ``S = 1`` draws
    exactly what the lone ``fit`` draws. Tenant ``s >= 1`` gets a generator
    seeded from ``numpy.random.SeedSequence([seed, s])`` of ``gen``'s seed:
    the streams of different ``(seed, tenant)`` pairs are unrelated, as
    ``jax.random.fold_in`` makes them in the reference.
    """
    if s == 0:
        return gen
    words = np.random.SeedSequence([gen.initial_seed(), s]).generate_state(
        2, np.uint32)
    seed = (int(words[0]) << 32 | int(words[1])) & ((1 << 63) - 1)
    return torch.Generator(device=gen.device).manual_seed(seed)


def seed_fleet_many(
    s: int,
    f: int,
    dim: int,
    base: dfo.DFOConfig,
    config: Optional[FleetConfig] = None,
    theta0: Optional[Tensor] = None,
    inits: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Seed ``S`` per-tenant restart fleets into one member-major block.

    Tenant ``t`` runs :func:`seed_fleet` under :func:`tenant_key`; its ``F``
    members occupy rows ``[t*F, (t+1)*F)``, matching the
    ``member_map = repeat(arange(S), F)`` routing of banked loss closures.

    Args:
      theta0: ``(S, dim)`` per-tenant baselines, or ``None`` for zeros.
      inits: ``(S, F - 1, dim)`` standard normals, or ``None`` to draw them.

    Returns:
      ``(theta0 (S*F, dim), sigmas (S*F,), lrs (S*F,))``.
    """
    parts = [
        seed_fleet(f, dim, base, config,
                   theta0=None if theta0 is None else theta0[t],
                   inits=None if inits is None else inits[t],
                   generator=(None if generator is None
                              else tenant_key(generator, t)),
                   device=device)
        for t in range(s)
    ]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def run_fleet(
    loss_fn: Callable[[Tensor], Tensor],
    theta0: Tensor,
    config: dfo.DFOConfig,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    sigma: Optional[Tensor] = None,
    learning_rate: Optional[Tensor] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> dfo.FleetDFOResult:
    """Optimize-then-refine: ``minimize_fleet``, then ``refine_steps`` passes
    of ``quadratic_refine_fleet`` at radius ``refine_radius / 2**i``.

    ``refine_samples`` is ``(refine_steps, F, m, dim)``; omitted draws come
    from ``generator``.
    """
    res = dfo.minimize_fleet(loss_fn, theta0, config, project=project,
                             sigma=sigma, learning_rate=learning_rate,
                             directions=directions, generator=generator)
    thetas = res.theta
    for i in range(refine_steps):
        thetas = dfo.quadratic_refine_fleet(
            loss_fn, thetas, radius=refine_radius / (2.0 ** i),
            project=project, generator=generator,
            samples=None if refine_samples is None else refine_samples[i],
        )
    return dfo.FleetDFOResult(theta=thetas, losses=res.losses)


def select_theta(
    loss_fn: Callable[[Tensor], Tensor],
    thetas: Tensor,
    traces: Tensor,
    select: str = "best",
    basin_tol: float = 0.05,
    guard: Optional[Tensor] = None,
    project: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused final selection: all members (+ optional guard) in ONE query.

    Returns ``(theta_tilde, trace, fleet_vals)``: the selected iterate, the
    loss trace of the member the selection measured against, and the
    ``(F,)`` final sketch loss per member.
    """
    f = thetas.shape[0]
    proj = project if project is not None else (lambda t: t)
    cand = thetas if guard is None else torch.cat([thetas, guard[None, :]])
    vals = loss_fn(cand)
    fleet_vals = vals[:f]
    best_member = torch.argmin(fleet_vals)
    if f > 1 and select == "average":
        best = torch.min(fleet_vals)
        keep = fleet_vals <= best * (1.0 + basin_tol) + 1e-12
        avg = proj(
            torch.where(keep[:, None], thetas, 0.0).sum(dim=0)
            / torch.clamp(keep.to(torch.float32).sum(), min=1.0)
        )
        runoff_rows = [avg, thetas[best_member]]
        if guard is not None:
            runoff_rows.append(cand[-1])
        runoff = torch.stack(runoff_rows)
        # argmin takes the first minimum: exact ties go to the average.
        theta_tilde = runoff[torch.argmin(loss_fn(runoff))]
        trace = traces[best_member]
    else:
        idx = torch.argmin(vals)
        theta_tilde = cand[idx]
        # If the guard won, report the best member's trace.
        trace = traces[torch.where(idx < f, idx, best_member)]
    return theta_tilde, trace, fleet_vals


def select_theta_many(
    loss_fn: Callable[[Tensor], Tensor],
    thetas: Tensor,
    traces: Tensor,
    select: str = "best",
    basin_tol: float = 0.05,
    guard: Optional[Tensor] = None,
    project: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-tenant :func:`select_theta` of a banked fleet, in one fused query.

    ``loss_fn`` is a banked closure with ``member_map = arange(S)``, so each
    tenant's candidate block reads its own sketch; ``thetas`` is
    ``(S, F, dim)`` and ``traces`` ``(S, F, steps)``. The guard is one
    shared ``(dim,)`` candidate evaluated per tenant. ``S = 1`` reproduces
    :func:`select_theta`.

    Returns ``(theta (S, dim), trace (S, steps), fleet_vals (S, F))``.
    """
    s, f, dim = thetas.shape
    proj = project if project is not None else (lambda t: t)
    rows = torch.arange(s, device=thetas.device)
    cand = thetas if guard is None else torch.cat(
        [thetas, guard.expand(s, 1, dim)], dim=1)
    vals = loss_fn(cand.reshape(s * cand.shape[1], dim)).reshape(
        s, cand.shape[1])
    fleet_vals = vals[:, :f]
    best_member = torch.argmin(fleet_vals, dim=1)
    if f > 1 and select == "average":
        best = torch.min(fleet_vals, dim=1, keepdim=True).values
        keep = fleet_vals <= best * (1.0 + basin_tol) + 1e-12
        avg = proj(
            torch.where(keep[:, :, None], thetas, 0.0).sum(dim=1)
            / torch.clamp(keep.to(torch.float32).sum(dim=1, keepdim=True),
                          min=1.0)
        )
        runoff_rows = [avg, thetas[rows, best_member]]
        if guard is not None:
            runoff_rows.append(cand[:, -1])
        runoff = torch.stack(runoff_rows, dim=1)
        runoff_vals = loss_fn(runoff.reshape(-1, dim)).reshape(
            s, runoff.shape[1])
        # argmin takes the first minimum: exact ties go to the average.
        theta = runoff[rows, torch.argmin(runoff_vals, dim=1)]
        trace = traces[rows, best_member]
    else:
        idx = torch.argmin(vals, dim=1)
        theta = cand[rows, idx]
        trace = traces[rows, torch.where(idx < f, idx, best_member)]
    return theta, trace, fleet_vals
