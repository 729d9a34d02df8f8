"""Derivative-free optimization over sketch queries (port of
``repro.core.dfo``, paper Algorithm 2).

Gradients come from antithetic sphere sampling (Nesterov-Spokoiny):

    g_hat = (d / (2 k sigma)) * sum_j [L(theta + sigma v_j) - L(theta - sigma v_j)] v_j

Each step of an ``F``-member fleet is ONE loss call of ``F * (2k + 1)``
points (the iterate rides along), so on the card a DFO step is one query
launch. ``lax.scan`` becomes a Python loop that never syncs with the host.

The random draws are injectable: sphere directions ``(steps, F, k, dim)``
and refine samples ``(F, m, dim)`` come from a ``torch.Generator`` unless
the caller passes them (parity runs replay the JAX draws).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.device import randn

Tensor = torch.Tensor
LossFn = Callable[[Tensor], Tensor]  # (q, dim) -> (q,)


class DFOResult(NamedTuple):
    theta: Tensor
    losses: Tensor  # (steps,) loss trace at the iterate


class FleetDFOResult(NamedTuple):
    theta: Tensor   # (F, dim) final iterates
    losses: Tensor  # (F, steps) per-member loss traces


@dataclasses.dataclass(frozen=True)
class DFOConfig:
    steps: int = 200
    num_queries: int = 8          # k in the paper (sigma-sphere points per step)
    sigma: float = 0.5            # sphere radius (paper: 0.5)
    sigma_decay: float = 1.0      # geometric sigma schedule
    learning_rate: float = 1.0
    decay: float = 0.999          # geometric lr decay
    antithetic: bool = True
    average_tail: float = 0.5     # Polyak-average this final fraction of iterates


def sphere_directions(gen: torch.Generator, steps: int, f: int, k: int,
                      dim: int, device) -> Tensor:
    """Unit directions ``(steps, F, k, dim)``: normalized standard normals."""
    v = randn((steps, f, k, dim), gen, device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _fleet_param(value: Optional[Union[float, Tensor]], default: float, f: int,
                 device) -> Tensor:
    """Broadcast a scalar or per-member hyperparameter to ``(F,)``."""
    arr = torch.as_tensor(default if value is None else value,
                          dtype=torch.float32, device=device)
    if arr.ndim == 0:
        return arr.expand(f).clone()
    if arr.shape != (f,):
        raise ValueError(f"per-fleet hyperparameter has shape "
                         f"{tuple(arr.shape)}, expected () or ({f},)")
    return arr


def _check_draws(t: Tensor, shape: tuple, what: str) -> Tensor:
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}; got "
                         f"{tuple(t.shape)}")
    return t


def minimize_fleet(
    loss_fn: LossFn,
    theta0: Tensor,
    config: DFOConfig,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    sigma: Optional[Union[float, Tensor]] = None,
    learning_rate: Optional[Union[float, Tensor]] = None,
    directions: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> FleetDFOResult:
    """Minimize F black-box losses with ONE fused loss call per step.

    Args:
      loss_fn: ``(q, dim) -> (q,)``, pointwise (each row independent).
      theta0: ``(F, dim)`` initial iterates.
      config: shared DFO hyperparameters.
      project: batch-polymorphic projection applied after each update.
      sigma / learning_rate: optional per-member ``(F,)`` overrides.
      directions: ``(steps, F, k, dim)`` unit directions; drawn from
        ``generator`` when omitted.
      generator: source of the directions when they are not given.

    Returns:
      ``(F, dim)`` final iterates and ``(F, steps)`` loss traces
      (``losses[f, t]`` is the loss at the iterate entering step ``t``).
    """
    f, dim = theta0.shape
    dev = theta0.device
    proj = project if project is not None else (lambda t: t)
    k = config.num_queries
    if directions is None:
        if generator is None:
            raise ValueError("minimize_fleet needs directions or a generator")
        directions = sphere_directions(generator, config.steps, f, k, dim, dev)
    directions = _check_draws(directions, (config.steps, f, k, dim),
                              "directions").to(dev)
    sig = _fleet_param(sigma, config.sigma, f, dev)
    lr = _fleet_param(learning_rate, config.learning_rate, f, dev)
    tail = (max(1, int(config.steps * config.average_tail))
            if config.average_tail > 0.0 else 0)

    theta = proj(theta0.to(torch.float32))
    losses, tail_sum = [], None
    for t in range(config.steps):
        v = directions[t]  # (F, k, dim)
        sv = sig[:, None, None] * v
        here = theta[:, None, :]
        if config.antithetic:
            pts = torch.cat([here + sv, here - sv, here], dim=1)
            vals = loss_fn(pts.reshape(f * (2 * k + 1), dim))
            vals = vals.reshape(f, 2 * k + 1)
            diff = vals[:, :k] - vals[:, k:2 * k]
            grad = (dim / (2.0 * k * sig))[:, None] * torch.einsum(
                "fk,fkd->fd", diff, v)
        else:
            pts = torch.cat([here + sv, here], dim=1)
            vals = loss_fn(pts.reshape(f * (k + 1), dim)).reshape(f, k + 1)
            grad = (dim / (k * sig))[:, None] * torch.einsum(
                "fk,fkd->fd", vals[:, :k] - vals[:, k:k + 1], v)
        losses.append(vals[:, -1])
        theta = proj(theta - lr[:, None] * grad)
        if t >= config.steps - tail:
            # A running sum, elementwise: a member's average then does not
            # depend on the fleet's size, as a reduction's order may (so a
            # fleet split over a mesh ends on the same bits).
            tail_sum = theta if tail_sum is None else tail_sum + theta
        lr = lr * config.decay
        sig = sig * config.sigma_decay

    if tail:
        # Polyak averaging over the noisy tail, re-projected onto the constraint.
        theta = proj(tail_sum / tail)
    return FleetDFOResult(theta=theta, losses=torch.stack(losses, dim=1))


def minimize(
    loss_fn: LossFn,
    theta0: Tensor,
    config: DFOConfig,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    directions: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> DFOResult:
    """The ``F = 1`` slice of :func:`minimize_fleet`.

    ``directions`` here is ``(steps, k, dim)``.
    """
    res = minimize_fleet(
        loss_fn, theta0[None, :], config, project=project,
        directions=None if directions is None else directions[:, None],
        generator=generator,
    )
    return DFOResult(theta=res.theta[0], losses=res.losses[0])


def _quadratic_model_step(delta: Tensor, vals: Tensor, radius: float,
                          ridge: float) -> Tensor:
    """Fit full quadratics to ``(F, m, dim)`` samples; return ``(F, dim)`` steps.

    Each member's model is fitted and solved on its own: the card's batched
    solvers choose their algorithm by batch size, so a batched solve would
    make a member's step depend on the fleet's size (a fleet split over a
    mesh must end on the meshless fleet's bits).
    """
    return torch.cat([_member_model_step(delta[i:i + 1], vals[i:i + 1],
                                         radius, ridge)
                      for i in range(delta.shape[0])])


def _member_model_step(delta: Tensor, vals: Tensor, radius: float,
                       ridge: float) -> Tensor:
    """:func:`_quadratic_model_step` of a ``(1, m, dim)`` block.

    The quadratic features follow ``torch.triu_indices`` (row-major, the
    order of ``jnp.triu_indices``).
    """
    f, m, dim = delta.shape
    dev = delta.device
    n_feat = 1 + dim + dim * (dim + 1) // 2
    iu = torch.triu_indices(dim, dim, device=dev)
    quad = (delta[..., :, None] * delta[..., None, :])[..., iu[0], iu[1]]
    feats = torch.cat([torch.ones((f, m, 1), device=dev), delta, quad], dim=-1)
    gram = feats.mT @ feats + ridge * torch.eye(n_feat, device=dev)
    coef = torch.linalg.solve(gram, feats.mT @ vals[..., None])[..., 0]
    g = coef[:, 1:1 + dim]
    # val = c + g.delta + 0.5 delta^T H delta: H = U + U^T for the fitted
    # upper-triangular coefficients U.
    u = torch.zeros((f, dim, dim), device=dev)
    u[:, iu[0], iu[1]] = coef[:, 1 + dim:]
    h = u + u.mT
    evals = torch.linalg.eigvalsh(h)
    lam = torch.clamp(1e-3 - evals.min(dim=-1).values, min=1e-4)
    eye = torch.eye(dim, device=dev)
    step = -torch.linalg.solve(h + lam[:, None, None] * eye, g[..., None])[..., 0]
    nrm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
    return step * torch.clamp(radius / (nrm + 1e-12), max=1.0)


def refine_sample_count(dim: int) -> int:
    """Default trust-region samples: three per quadratic feature."""
    return 3 * (1 + dim + dim * (dim + 1) // 2)


def quadratic_refine_fleet(
    loss_fn: LossFn,
    theta: Tensor,
    radius: float = 0.3,
    num_samples: Optional[int] = None,
    ridge: float = 1e-6,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    samples: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Fleet-batched quadratic-model polish: two fused loss calls in total.

    Args:
      theta: ``(F, dim)`` iterates to polish.
      samples: ``(F, m, dim)`` standard normals placing the trust-region
        points ``theta + radius * samples / sqrt(dim)``; drawn from
        ``generator`` when omitted.
    """
    f, dim = theta.shape
    proj = project if project is not None else (lambda t: t)
    m = num_samples if num_samples is not None else refine_sample_count(dim)
    if samples is None:
        if generator is None:
            raise ValueError("quadratic_refine_fleet needs samples or a "
                             "generator")
        samples = randn((f, m, dim), generator, theta.device)
    samples = _check_draws(samples, (f, m, dim), "refine samples").to(
        theta.device)
    pts = theta[:, None, :] + radius * samples / math.sqrt(dim)
    vals = loss_fn(pts.reshape(f * m, dim)).reshape(f, m)
    step = _quadratic_model_step(pts - theta[:, None, :], vals, radius, ridge)
    cand = proj(theta + step)
    accept = loss_fn(torch.stack([cand, theta], dim=1).reshape(2 * f, dim))
    accept = accept.reshape(f, 2)
    return torch.where((accept[:, 0] <= accept[:, 1])[:, None], cand, theta)


def quadratic_refine(
    loss_fn: LossFn,
    theta: Tensor,
    radius: float = 0.3,
    num_samples: Optional[int] = None,
    ridge: float = 1e-6,
    project: Optional[Callable[[Tensor], Tensor]] = None,
    samples: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """The ``F = 1`` slice of :func:`quadratic_refine_fleet`; ``samples`` is
    ``(m, dim)``."""
    return quadratic_refine_fleet(
        loss_fn, theta[None, :], radius=radius, num_samples=num_samples,
        ridge=ridge, project=project,
        samples=None if samples is None else samples[None],
        generator=generator,
    )[0]


def pin_last_coordinate(value: float = -1.0) -> Callable[[Tensor], Tensor]:
    """Projection pinning ``theta_tilde[..., -1]`` (Algorithm 2's constraint)."""

    def proj(t: Tensor) -> Tensor:
        out = t.clone()
        out[..., -1] = value
        return out

    return proj
