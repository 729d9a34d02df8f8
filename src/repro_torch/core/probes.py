"""STORM linear probes on LM hidden states (port of ``repro.core.probes``;
DESIGN.md §4, integration #2).

Pooled hidden states of a frozen model stream into a PRP sketch together
with a scalar target, the states are dropped, and a linear value head is
recovered from the counters alone. Shard-local probe sketches merge by
adding counters and pooling the standardization moments n-weighted.

Training is the ERM spine's PRP regression (``erm.fit`` / ``erm.fit_many``):
on the card every DFO step is one query launch at ``d_model + 3`` hash
dimensions, and ``fit_probe_sharded`` splits the restart fleet over a
:class:`~repro_torch.sharding.mesh.Mesh` against the replicated sketch
(``distributed.fleet_fit``). Where the reference takes a threefry key, the
port takes a ``torch.Generator`` (``None``: seed 0 on the run's device) or
the draws themselves, as ``regression.fit`` does: ``params`` (the hash
family), ``inits``, ``directions`` and ``refine_samples`` (``erm.fit``'s
draw order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import dfo, erm, fleet, losses, lsh, sketch as sketch_lib
from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

# The registered surrogate the probe head trains (PRP regression at
# d_model scale).
_SPEC = losses.PRP_REGRESSION


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Sketch-build knobs (pooling is an argument of ``pool_hidden``)."""

    rows: int = 2048
    planes: int = 4
    batch: int = 256
    norm_slack: float = 1.05      # unit-ball scaling slack (quantile-based)
    engine: str = "auto"          # insert path: scan | kernel | auto


class ProbeState(NamedTuple):
    """Everything an edge worker retains after seeing its stream."""

    sketch: sketch_lib.Sketch
    params: lsh.LSHParams
    x_mean: Tensor
    x_scale: Tensor
    y_mean: Tensor
    y_scale: Tensor
    scale: Tensor                  # unit-ball scale factor
    count: Optional[Tensor] = None  # shard-local n (moment-merge weights)

    @property
    def n(self) -> Tensor:
        """Shard-local example count; the sketch's insert count if unset."""
        return self.count if self.count is not None else self.sketch.n


def pool_hidden(hidden: Tensor, pool: str) -> Tensor:
    """(B, S, d) -> (B, d)."""
    if pool == "mean":
        return hidden.mean(dim=1)
    if pool == "last":
        return hidden[:, -1, :]
    raise ValueError(pool)


def extract_features(params: Any, cfg: ModelConfig, batch: Dict[str, Tensor],
                     pool: str) -> Tensor:
    """Frozen-model features for a token batch."""
    hidden, _ = model.forward(params, cfg, batch)
    return pool_hidden(hidden.to(torch.float32), pool)


_MOMENT_EPS = 1e-8  # std guard, shared with the merge's strip/re-apply


class ProbeMoments(NamedTuple):
    """The standardization a probe sketch was built under (rows added to the
    sketch later, and the fitted head's un-standardization, need it)."""

    x_mean: Tensor
    x_scale: Tensor
    y_mean: Tensor
    y_scale: Tensor
    scale: Tensor


def probe_rows(feats: Tensor, targets: Tensor,
               config: Optional[ProbeConfig] = None,
               moments: Optional[ProbeMoments] = None
               ) -> Tuple[Tensor, ProbeMoments]:
    """Standardize ``(features (N, d), targets (N,))`` into sketch-space rows
    ``(N, d + 1)``.

    ``moments=None`` computes the moments and the unit-ball scale from this
    batch (population stds). Given frozen ``moments`` the map is elementwise
    per row (outlier norms clip onto the sphere), so rows made window by
    window equal the rows of one batch under the same moments bit for bit:
    the telemetry bridge and the offline comparator both call this.
    """
    config = config or ProbeConfig()
    if moments is None:
        xm = feats.mean(0)
        xs = feats.std(0, correction=0) + _MOMENT_EPS
        ym = targets.mean()
        ys = targets.std(correction=0) + _MOMENT_EPS
        z = torch.cat([(feats - xm) / xs, ((targets - ym) / ys)[:, None]],
                      dim=-1)
        zs, c = lsh.scale_to_unit_ball(z, config.norm_slack)
        return zs, ProbeMoments(x_mean=xm, x_scale=xs, y_mean=ym, y_scale=ys,
                                scale=c)
    z = torch.cat([(feats - moments.x_mean) / moments.x_scale,
                   ((targets - moments.y_mean) / moments.y_scale)[:, None]],
                  dim=-1)
    # scale_to_unit_ball's tail with the scale pinned: drifted live data may
    # leave the reference ball; clip it, never NaN.
    zs = z / moments.scale
    nrm = torch.linalg.vector_norm(zs, dim=-1, keepdim=True)
    return zs / torch.clamp(nrm, min=1.0), moments


def sketch_features(
    gen: Optional[torch.Generator],
    feats: Tensor,
    targets: Tensor,
    config: Optional[ProbeConfig] = None,
    moments: Optional[ProbeMoments] = None,
    *,
    params: Optional[lsh.LSHParams] = None,
    device: DeviceLike = None,
) -> ProbeState:
    """One-pass PRP sketch of ``(features, target)`` pairs.

    The hash family is ``params`` or drawn from ``gen`` (``rows x planes``
    over ``d + 3`` dimensions; ``gen=None``: seed 0). ``moments=None``
    standardizes by the batch's own statistics; frozen ``moments`` give the
    offline comparator of a sketch ingested window by window under them.
    Runs on ``device`` (``None``: the card, raising without one): on the
    card the insert is one launch of kernel 1 (the wide body at
    ``d_model`` scale).
    """
    config = config or ProbeConfig()
    dev = resolve_device(device)
    feats = feats.to(dev, torch.float32)
    targets = targets.to(dev, torch.float32)
    zs, moments = probe_rows(feats, targets, config, moments=moments)
    if params is None:
        gen = gen if gen is not None else make_generator(0, dev)
        params = lsh.init_srp(gen, config.rows, config.planes,
                              zs.shape[1] + 2, device=dev)
    sk = sketch_lib.sketch_dataset(params, zs, batch=config.batch,
                                   paired=True, engine=config.engine,
                                   device=dev)
    return ProbeState(
        sketch=sk, params=lsh.LSHParams(projections=params.projections.to(dev)),
        x_mean=moments.x_mean, x_scale=moments.x_scale,
        y_mean=moments.y_mean, y_scale=moments.y_scale, scale=moments.scale,
        count=torch.tensor(feats.shape[0], dtype=torch.int32, device=dev))


def merge_probe_states(states: Sequence[ProbeState]) -> ProbeState:
    """Merge shard-local probe sketches: counters add exactly, moments pool
    n-weighted.

    Means pool exactly; stds through the population-variance law ``var =
    sum_i w_i (var_i + (mean_i - mean)^2)`` (the eps guard stripped and
    re-applied). The unit-ball ``scale`` is a norm quantile with no exact
    merge: the n-weighted mean, exact for homogeneous shards. The counters
    stay each shard's own standardization, so they equal one global sketch
    only when the shards were sketched under shared moments.
    """
    base = states[0]
    merged = base.sketch
    for s in states[1:]:
        merged = sketch_lib.merge(merged, s.sketch)
    ns = torch.stack([torch.as_tensor(s.n).to(torch.float32)
                      for s in states])
    w = ns / torch.sum(ns)

    def pool_mean(vals):
        return torch.einsum("s,s...->...", w, torch.stack(vals))

    def pool_std(means, scales, pooled_mean):
        var = torch.stack([(sc - _MOMENT_EPS) ** 2 + (m - pooled_mean) ** 2
                           for m, sc in zip(means, scales)])
        pooled_var = torch.einsum("s,s...->...", w, var)
        return torch.sqrt(torch.clamp(pooled_var, min=0.0)) + _MOMENT_EPS

    x_mean = pool_mean([s.x_mean for s in states])
    y_mean = pool_mean([s.y_mean for s in states])
    return ProbeState(
        sketch=merged, params=base.params, x_mean=x_mean,
        x_scale=pool_std([s.x_mean for s in states],
                         [s.x_scale for s in states], x_mean),
        y_mean=y_mean,
        y_scale=pool_std([s.y_mean for s in states],
                         [s.y_scale for s in states], y_mean),
        scale=pool_mean([s.scale for s in states]),
        count=torch.sum(ns).to(torch.int32),
    )


class FittedProbe(NamedTuple):
    theta: Tensor
    intercept: Tensor
    losses: Optional[Tensor] = None        # DFO trace of the selected member
    fleet_losses: Optional[Tensor] = None  # (F,) final sketch loss per member

    def predict(self, feats: Tensor) -> Tensor:
        return feats @ self.theta + self.intercept

    def mse(self, feats: Tensor, targets: Tensor) -> Tensor:
        return torch.mean((self.predict(feats) - targets) ** 2)


_PROBE_DFO = dfo.DFOConfig(
    steps=300, num_queries=8, sigma=0.5, sigma_decay=0.995,
    learning_rate=2.0, decay=0.995, average_tail=0.5,
)


def _unstandardize(state: ProbeState, theta_std: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    theta = state.y_scale * theta_std / state.x_scale
    return theta, state.y_mean - torch.dot(state.x_mean, theta)


def _state_on(state: ProbeState, dev: torch.device) -> ProbeState:
    """``state`` with every tensor on ``dev``."""
    sk = sketch_lib.Sketch(counts=state.sketch.counts.to(dev),
                           n=state.sketch.n.to(dev))
    moved = [None if t is None else t.to(dev) for t in state[2:]]
    return ProbeState(sk, lsh.LSHParams(state.params.projections.to(dev)),
                      *moved)


def fit_probe(
    gen: Optional[torch.Generator],
    state: ProbeState,
    d_model: int,
    dfo_config: Optional[dfo.DFOConfig] = None,
    l2: float = 3e-2,
    restarts: int = 1,
    fleet_config: Optional[fleet.FleetConfig] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    engine: str = "auto",
    *,
    inits: Optional[Tensor] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedProbe:
    """Recover the linear value head from counters only (Algorithm 2).

    ``l2`` ridge-regularizes the DFO objective: at d_model scale the
    frozen-hash noise rewards magnitude overshoot. ``restarts=F`` trains an
    F-member fleet (one fused ``F*(2k+1)``-point query per DFO step) and
    selects by final sketch loss. Draws not passed in come from ``gen``.
    Runs on ``device`` (``None``: the card).
    """
    dev = resolve_device(device)
    state = _state_on(state, dev)
    gen = gen if gen is not None else make_generator(0, dev)
    res = erm.fit(
        _SPEC, state.sketch, state.params, dfo_config=dfo_config or _PROBE_DFO,
        fleet_config=fleet_config, restarts=restarts, l2=l2, engine=engine,
        refine_steps=refine_steps, refine_radius=refine_radius,
        generator=gen, inits=inits, directions=directions,
        refine_samples=refine_samples, device=dev,
    )
    theta, intercept = _unstandardize(state, res.theta[:d_model])
    return FittedProbe(theta=theta, intercept=intercept, losses=res.losses,
                       fleet_losses=res.fleet_losses)


def fit_probe_sharded(
    gen: Optional[torch.Generator],
    state: ProbeState,
    d_model: int,
    mesh=None,
    axis: str = "fleet",
    restarts: int = 8,
    dfo_config: Optional[dfo.DFOConfig] = None,
    l2: float = 3e-2,
    fleet_config: Optional[fleet.FleetConfig] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    engine: str = "auto",
    *,
    inits: Optional[Tensor] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedProbe:
    """``fit_probe`` with the restart fleet split over ``mesh``'s ``axis``.

    The merged sketch replicates to every shard and each shard advances its
    block of members with no collective (``distributed.fleet_fit``);
    ``mesh=None`` runs the same program on ``device``. The draws come in
    ``fit_probe``'s order (``inits``, then ``directions``, then
    ``refine_samples``), so ``mesh=None`` is ``fit_probe(restarts=F)`` bit
    for bit, and so is any mesh.
    """
    from repro_torch.core import distributed  # deferred: imports core

    dev = mesh.first if mesh is not None else resolve_device(device)
    state = _state_on(state, dev)
    gen = gen if gen is not None else make_generator(0, dev)
    cfg_d = dfo_config or _PROBE_DFO
    f = max(1, restarts)
    fc = fleet_config or fleet.FleetConfig()
    fleet.validate_select(fc.select)
    theta0, sigmas, lrs = fleet.seed_fleet(
        f, d_model + 1, cfg_d, fc, inits=inits, generator=gen, device=dev)
    result = distributed.fleet_fit(
        state.sketch, state.params, theta0, cfg_d, mesh=mesh, axis=axis,
        sigma=sigmas, learning_rate=lrs, refine_steps=refine_steps,
        refine_radius=refine_radius, l2=l2, engine=engine,
        directions=directions, refine_samples=refine_samples, generator=gen,
    )
    loss_fn = erm.surrogate_loss_fn(_SPEC, state.sketch, state.params,
                                    l2=l2, engine=engine)
    proj = dfo.pin_last_coordinate(-1.0)
    theta_tilde, trace, fleet_vals = fleet.select_theta(
        loss_fn, result.theta.to(dev), result.losses.to(dev),
        select=fc.select, basin_tol=fc.basin_tol,
        guard=proj(torch.zeros((d_model + 1,), dtype=torch.float32,
                               device=dev)), project=proj,
    )
    theta, intercept = _unstandardize(state, theta_tilde[:d_model])
    return FittedProbe(theta=theta, intercept=intercept, losses=trace,
                       fleet_losses=fleet_vals)


# ---------------------------------------------------------------------------
# Tenant-batched probes: S value heads against one SketchBank
# ---------------------------------------------------------------------------


class FittedProbeMany(NamedTuple):
    """S per-tenant value heads recovered from one fused banked fleet."""

    theta: Tensor          # (S, d_model)
    intercept: Tensor      # (S,)
    losses: Tensor         # (S, steps)
    fleet_losses: Tensor   # (S, F)

    @property
    def tenants(self) -> int:
        return self.theta.shape[0]

    def select(self, i: int) -> FittedProbe:
        """Tenant ``i`` as a standalone :class:`FittedProbe`."""
        return FittedProbe(theta=self.theta[i], intercept=self.intercept[i],
                           losses=self.losses[i],
                           fleet_losses=self.fleet_losses[i])

    def predict(self, feats: Tensor) -> Tensor:
        """Per-tenant predictions for ``feats: (S, n, d_model)`` -> (S, n)."""
        return torch.einsum("snd,sd->sn", feats, self.theta) \
            + self.intercept[:, None]

    def mse(self, feats: Tensor, targets: Tensor) -> Tensor:
        return torch.mean((self.predict(feats) - targets) ** 2, dim=-1)


def fit_probe_many(
    gen: Optional[torch.Generator],
    states: Sequence[ProbeState],
    d_model: int,
    dfo_config: Optional[dfo.DFOConfig] = None,
    l2: float = 3e-2,
    restarts: int = 1,
    fleet_config: Optional[fleet.FleetConfig] = None,
    refine_steps: int = 0,
    refine_radius: float = 0.3,
    engine: str = "auto",
    *,
    inits: Optional[Tensor] = None,
    directions: Optional[Tensor] = None,
    refine_samples: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> FittedProbeMany:
    """Recover S per-tenant value heads from S probe sketches in one fleet.

    The states' tables stack into a :class:`~.sketch.SketchBank` and an
    ``S*F``-member fleet trains on one fused banked query per DFO step (on
    the card one launch of kernel 6). Each head un-standardizes through its
    own state's moments. ``S = 1`` is ``fit_probe(restarts=F)`` bit for bit.
    The states must share ONE hash family. Draws passed in cover all
    tenants (``erm.fit_many``'s layout).
    """
    states = list(states)
    if not states:
        raise ValueError("fit_probe_many needs at least one ProbeState")
    dev = resolve_device(device)
    states = [_state_on(st, dev) for st in states]
    base = states[0].params.projections
    if any(st.params.projections.shape != base.shape
           or not torch.equal(st.params.projections, base)
           for st in states[1:]):
        raise ValueError(
            "fit_probe_many needs states sketched under ONE shared hash "
            "family; got differing LSHParams"
        )
    gen = gen if gen is not None else make_generator(0, dev)
    bank = sketch_lib.bank_of([st.sketch for st in states])
    res = erm.fit_many(
        _SPEC, bank, states[0].params, dfo_config=dfo_config or _PROBE_DFO,
        fleet_config=fleet_config, restarts=restarts, l2=l2, engine=engine,
        refine_steps=refine_steps, refine_radius=refine_radius,
        generator=gen, inits=inits, directions=directions,
        refine_samples=refine_samples, device=dev,
    )
    theta_std = res.theta[:, :d_model]
    y_scale = torch.stack([st.y_scale for st in states])
    x_scale = torch.stack([st.x_scale for st in states])
    theta = y_scale[:, None] * theta_std / x_scale
    # Per-tenant dot, as fit_probe's: one fused contraction would reorder
    # the d-sum and move the S = 1 intercept off fit_probe's.
    intercept = torch.stack([st.y_mean - torch.dot(st.x_mean, theta[t])
                             for t, st in enumerate(states)])
    return FittedProbeMany(theta=theta, intercept=intercept,
                           losses=res.losses, fleet_losses=res.fleet_losses)
