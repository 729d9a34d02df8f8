"""Differential privacy for STORM sketches (port of ``repro.core.privacy``).

The mechanism math is wrapped by three serving-facing types:

* :class:`ReleasePolicy`: a declarative release contract (mechanism, the
  eps charged per release, the noise scale as host math) shared by the
  gateways and the wire. ``epsilon_release = inf`` is the identity policy:
  callers bypass the private machinery, so unlimited serving equals the
  non-private gateways by construction.
* :class:`EpsilonLedger`: per-tenant budget accounting under sequential
  composition. Spend on release, append-only, exact sums by ``math.fsum``;
  exhaustion is a :class:`BudgetState`, not an exception.
* :class:`PrivateBankView`: privatize-on-read over banked counters. ONE
  noisy release per (tenant, counter version) covers every query coalesced
  into that release window, and the noise is kept, so re-reads of
  unchanged counters are free (post-processing of the same release).

Two mechanisms:

* **Private counts**: Laplace (or Gaussian) noise on every counter. One
  example touches ``R`` counters (``2R`` for PRP), so the count array's L1
  sensitivity is ``R`` (``2R``). The release is ``f32(counts) + noise``:
  float tables, which the queries read through the RACE kernels' f32
  variant.
* **Private projections**: Gaussian noise on the projection values before
  the sign (the JL mechanism). The PRP insert makes ONE full-rank release of
  the per-plane pair ``(s, t) = (z . w_z, pad * w_pad)`` and derives both
  antithetic code sets from it (:func:`private_prp_codes`).

Random draws: the reference draws the mechanism noise with ``jax.random``,
which torch cannot reproduce. Here it comes from an explicit
``torch.Generator`` (Laplace by the inverse CDF of ``torch.rand``), and
every function also takes the draws as tensors (``noise``, ``e_s``/``e_t``),
so a test can pass the reference's draws across. The release-window noise
of :class:`PrivateBankView` is numpy on the host in the reference too, and
it is the same call here: the same seed gives the same bits.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lsh, sketch as sketch_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PrivateSketch:
    """A released sketch: float counts (noise added), original insert count."""

    counts: Tensor
    n: Tensor

    @property
    def rows(self) -> int:
        return self.counts.shape[0]

    @property
    def buckets(self) -> int:
        return self.counts.shape[1]


def _laplace(generator: torch.Generator, shape, device) -> Tensor:
    """Standard Laplace draws by the inverse CDF of ``torch.rand``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32) - 0.5
    tail = torch.clamp(1.0 - 2.0 * u.abs(), min=torch.finfo(torch.float32).tiny)
    return -torch.sign(u) * torch.log(tail)


def count_noise(generator: Optional[torch.Generator], shape, epsilon: float,
                rows: int, paired: bool = True, mechanism: str = "laplace",
                delta: float = 1e-6, device=None) -> Tensor:
    """Sample the f32 noise table of one count release.

    One example touches ``rows`` counters (``2*rows`` for PRP): L1
    sensitivity ``rows`` (``2*rows``), L2 ``sqrt`` of that. ``laplace``
    gives pure ``epsilon``-DP, ``gaussian`` ``(epsilon, delta)``-DP at the
    :func:`gaussian_sigma` scale. Drawn from ``generator`` on its device
    (or ``device``).
    """
    touched = (2.0 if paired else 1.0) * rows
    dev = generator.device if device is None else device
    if mechanism == "laplace":
        scale = touched / float(epsilon)
        return _laplace(generator, shape, dev) * scale
    if mechanism == "gaussian":
        sigma = gaussian_sigma(epsilon, delta, sensitivity=math.sqrt(touched))
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * sigma
    raise ValueError(f"unknown mechanism {mechanism!r}; "
                     f"choose 'laplace' or 'gaussian'")


def privatize_counts(
    generator: Optional[torch.Generator], sk: sketch_lib.Sketch,
    epsilon: float, paired: bool = True, mechanism: str = "laplace",
    delta: float = 1e-6, noise: Optional[Tensor] = None,
) -> PrivateSketch:
    """Release the sketch with example-level DP on the counters.

    The counters are widened to f32 BEFORE the noise add: on narrow banks
    (int16/int8) adding float noise in the integer dtype would truncate or
    saturate the noise itself and break the mechanism's calibration. The
    release is ``f32(counts) + noise``, never a narrow add. ``noise``
    (``counts``-shaped f32) replaces the draw from ``generator``.
    """
    if noise is None:
        noise = count_noise(generator, sk.counts.shape, epsilon, sk.rows,
                            paired=paired, mechanism=mechanism, delta=delta,
                            device=sk.counts.device)
    return PrivateSketch(counts=sk.counts.to(torch.float32) + noise, n=sk.n)


def query_private(ps: PrivateSketch, codes: Tensor,
                  paired: bool = True) -> Tensor:
    """RACE estimate over a privatized sketch: the same gather and mean as
    ``sketch.query`` (the float sum in float64, ``sketch.mean_count``)."""
    rows = torch.arange(codes.shape[-1], device=codes.device).expand(
        codes.shape)
    gathered = ps.counts[rows, codes.long()]
    return sketch_lib.mean_count(gathered) / sketch_lib.denominator(ps.n,
                                                                    paired)


def gaussian_sigma(epsilon: float, delta: float,
                   sensitivity: float = 2.0) -> float:
    """Analytic-Gaussian-style noise scale of the JL projection mechanism,
    as a Python float (callers bake it into configs)."""
    return float(sensitivity) * math.sqrt(2.0 * math.log(1.25 / float(delta))) \
        / float(epsilon)


# ---------------------------------------------------------------------------
# The privacy layer: policy, ledger, privatize-on-read view
# ---------------------------------------------------------------------------


class BudgetState(enum.Enum):
    """Typed budget status: serving routes on it, it never raises."""

    OK = "ok"
    EXHAUSTED = "exhausted"


@dataclasses.dataclass(frozen=True)
class ReleasePolicy:
    """Declarative release contract shared by the gateways and the wire.

    Attributes:
      epsilon_total: per-tenant lifetime budget; ``inf`` = unlimited.
      epsilon_release: eps charged per count release. ``inf`` marks the
        identity (noiseless) policy: callers bypass the private machinery
        (``noiseless``), so unlimited serving equals the non-private path
        by construction.
      delta: failure probability of the ``gaussian`` mechanism.
      mechanism: ``"laplace"`` (pure eps-DP) or ``"gaussian"``.
      on_exhaust: what an exhausted tenant's reads get: ``"refuse"`` (a
        typed refusal; the wire's terminal ``budget_exceeded`` frame) or
        ``"stale"`` (the last cached release, free under post-processing).
    """

    epsilon_total: float = math.inf
    epsilon_release: float = 1.0
    delta: float = 1e-6
    mechanism: str = "laplace"
    on_exhaust: str = "refuse"

    def __post_init__(self):
        if self.mechanism not in ("laplace", "gaussian"):
            raise ValueError(f"unknown mechanism {self.mechanism!r}")
        if self.on_exhaust not in ("refuse", "stale"):
            raise ValueError(f"unknown on_exhaust {self.on_exhaust!r}")
        if not self.epsilon_release > 0:
            raise ValueError("epsilon_release must be positive")
        if not self.epsilon_total > 0:
            raise ValueError("epsilon_total must be positive")
        if math.isinf(self.epsilon_release) and \
                not math.isinf(self.epsilon_total):
            raise ValueError("a noiseless policy (epsilon_release=inf) "
                             "cannot have a finite epsilon_total")
        if self.mechanism == "gaussian" and not 0.0 < self.delta < 1.0:
            raise ValueError(f"gaussian delta must be in (0, 1); "
                             f"got {self.delta}")

    @classmethod
    def unlimited(cls) -> "ReleasePolicy":
        """The identity policy: no noise, no accounting."""
        return cls(epsilon_total=math.inf, epsilon_release=math.inf)

    @property
    def noiseless(self) -> bool:
        return math.isinf(self.epsilon_release)

    def noise_scale(self, rows: int, paired: bool = True) -> float:
        """Per-cell noise scale of one release, as a Python float."""
        if self.noiseless:
            return 0.0
        touched = (2.0 if paired else 1.0) * rows
        if self.mechanism == "laplace":
            return touched / self.epsilon_release
        return gaussian_sigma(self.epsilon_release, self.delta,
                              sensitivity=math.sqrt(touched))

    def sample_noise(self, generator: Optional[torch.Generator], shape,
                     paired: bool = True, device=None) -> Tensor:
        """One release's f32 noise table for ``(R, B)``-shaped counters."""
        if self.noiseless:
            dev = generator.device if device is None else device
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        return count_noise(generator, shape, self.epsilon_release, shape[-2],
                           paired=paired, mechanism=self.mechanism,
                           delta=self.delta, device=device)


class EpsilonLedger:
    """Per-tenant eps accounting under sequential composition.

    Spend on release with an append-only per-tenant log: ``spent`` is
    ``math.fsum`` over the log (exact against the closed-form sum), hence
    monotone. A release is affordable iff the remaining budget covers its
    FULL cost; exactly zero remaining refuses. ``charge`` never raises.
    """

    def __init__(self, policy: ReleasePolicy):
        self.policy = policy
        self._log: Dict[int, List[float]] = {}

    def keys(self):
        return sorted(self._log)

    def spend_log(self, tenant: int) -> List[float]:
        return list(self._log.get(tenant, ()))

    def spent(self, tenant: int) -> float:
        return math.fsum(self._log.get(tenant, ()))

    def remaining(self, tenant: int) -> float:
        return self.policy.epsilon_total - self.spent(tenant)

    def state(self, tenant: int) -> BudgetState:
        if self.policy.noiseless:
            return BudgetState.OK
        if self.remaining(tenant) >= self.policy.epsilon_release:
            return BudgetState.OK
        return BudgetState.EXHAUSTED

    def charge(self, tenant: int) -> BudgetState:
        """Spend one release's eps if affordable; else EXHAUSTED, no spend."""
        if self.policy.noiseless:
            return BudgetState.OK
        if self.state(tenant) is BudgetState.EXHAUSTED:
            return BudgetState.EXHAUSTED
        self._log.setdefault(tenant, []).append(self.policy.epsilon_release)
        return BudgetState.OK


@dataclasses.dataclass
class _Window:
    """One cached release: the counter version it covers and its noise."""

    version: int
    noise: np.ndarray  # (R, B) f32, on the host


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """The host-side verdict of one tenant's read at one counter version.

    * ``"fresh"``: rebuild ``f32(counts) + noise`` (a new release if
      ``spent``, a free rebuild of the cached one if not).
    * ``"stale"``: serve the last release already on a device lane
      (post-processing: free); ``n`` is the release-time count.
    * ``"refuse"``: exhausted with no stale release available (or the
      policy refuses); the caller completes the request with a refusal.
    """

    status: str
    noise: Optional[np.ndarray]
    n: int
    spent: bool


class PrivateBankView:
    """Privatize-on-read over banked counters with per-tenant windows.

    The view owns the host-side release bookkeeping; the CALLER owns the
    counters (device bank, host cold copy or standalone sketch) and, for
    gateways, the device lane buffer that holds the last released tables.
    A release window is one counter version (cumulative inserted rows,
    tracked exactly on the host by the caller, which packs the rows): the
    first read of a version samples noise and charges the ledger; every
    further read of the SAME version reuses the cached noise (the same
    release, free). New ingest closes the window.

    ``mark_resident`` / ``drop_resident`` track whose last release lives on
    a caller-side device lane, the only thing a ``"stale"`` plan may serve.
    A demoted tenant's lane is dropped; its window survives, so
    re-promotion at an unchanged version rebuilds the SAME release free.
    """

    def __init__(self, policy: ReleasePolicy, *,
                 ledger: Optional[EpsilonLedger] = None, seed: int = 0):
        self.policy = policy
        self.ledger = ledger if ledger is not None else EpsilonLedger(policy)
        self._seed = int(seed)
        self._windows: Dict[int, _Window] = {}
        self._lane_n: Dict[int, int] = {}  # tenant -> release n on its lane
        self._seq = 0  # global release ordinal (the noise stream's position)
        self.releases = 0  # fresh (charged) releases, for stats

    def _sample(self, shape, paired: bool) -> np.ndarray:
        """Host-side noise draw, keyed by (seed, release ordinal).

        numpy's ``default_rng`` (PCG64) on the host, the reference's own
        call, so tick packing never waits on the device; the gateway ships
        the noise in its fused tick transfer like any other packed traffic.
        """
        rng = np.random.default_rng((self._seed, self._seq))
        scale = self.policy.noise_scale(shape[-2], paired=paired)
        if self.policy.mechanism == "laplace":
            draw = rng.laplace(0.0, scale, size=shape)
        else:
            draw = rng.normal(0.0, scale, size=shape)
        return draw.astype(np.float32)

    def plan_read(self, tenant: int, version: int, shape,
                  paired: bool = True) -> ReadPlan:
        """Plan one read of ``tenant`` at counter ``version`` (= its n)."""
        w = self._windows.get(tenant)
        if w is not None and w.version == version:
            # Open window: same counters, same noise; a free re-read.
            return ReadPlan("fresh", w.noise, version, spent=False)
        if self.policy.noiseless:
            return ReadPlan("fresh", np.zeros(shape, np.float32), version,
                            spent=False)
        if self.ledger.charge(tenant) is BudgetState.OK:
            self._seq += 1
            noise = self._sample(shape, paired)
            self._windows[tenant] = _Window(version=version, noise=noise)
            self.releases += 1
            return ReadPlan("fresh", noise, version, spent=True)
        if self.policy.on_exhaust == "stale" and tenant in self._lane_n:
            return ReadPlan("stale", None, self._lane_n[tenant], spent=False)
        return ReadPlan("refuse", None, 0, spent=False)

    def mark_resident(self, tenant: int) -> None:
        """The tenant's current window release now lives on a device lane."""
        w = self._windows.get(tenant)
        if w is not None:
            self._lane_n[tenant] = w.version

    def drop_resident(self, tenant: int) -> None:
        """The tenant's lane was reused (demotion): stale serving stops."""
        self._lane_n.pop(tenant, None)

    def read(self, tenant: int, sk: sketch_lib.Sketch,
             version: Optional[int] = None, paired: bool = True
             ) -> Tuple[ReadPlan, Optional[PrivateSketch]]:
        """Standalone privatize-on-read of one sketch (fit paths, tests).

        Returns the plan and, for a ``"fresh"`` plan, the released sketch
        on the sketch's device; ``"stale"`` and ``"refuse"`` give ``None``
        (a stale release lives on the CALLER's lane buffer).
        """
        if version is None:
            version = int(sk.n)  # a host read; gateways pass their tracker
        plan = self.plan_read(tenant, version, tuple(sk.counts.shape),
                              paired=paired)
        if plan.status != "fresh":
            return plan, None
        dev = sk.counts.device
        released = sk.counts.to(torch.float32) + torch.from_numpy(
            plan.noise).to(dev)
        return plan, PrivateSketch(counts=released, n=torch.tensor(
            plan.n, dtype=torch.int32, device=dev))

    def summary(self) -> dict:
        """JSON-safe budget snapshot for the wire's stats and budget frames."""
        def _fin(x: float):
            return None if math.isinf(x) else x
        led = self.ledger
        keys = led.keys()
        return {
            "mechanism": self.policy.mechanism,
            "on_exhaust": self.policy.on_exhaust,
            "epsilon_total": _fin(self.policy.epsilon_total),
            "epsilon_release": _fin(self.policy.epsilon_release),
            "delta": self.policy.delta,
            "releases": self.releases,
            "spent": {str(t): led.spent(t) for t in keys},
            "remaining": {str(t): _fin(led.remaining(t)) for t in keys},
            "exhausted": [t for t in keys
                          if led.state(t) is BudgetState.EXHAUSTED],
        }


def _pack_codes(bits: Tensor, r: int, p: int) -> Tensor:
    """``(..., R*p)`` sign bits -> ``(..., R)`` int32 codes (bit j = plane j)."""
    bits = bits.reshape(bits.shape[:-1] + (r, p)).to(torch.int32)
    weights = 2 ** torch.arange(p, dtype=torch.int32, device=bits.device)
    return (bits * weights).sum(-1, dtype=torch.int32)


def private_srp_codes(
    generator: Optional[torch.Generator], params: lsh.LSHParams, x: Tensor,
    sigma: float, noise: Optional[Tensor] = None,
) -> Tensor:
    """SRP codes with Gaussian noise on the projection values (pre-sign).

    ``noise``: the ``(..., R*p)`` standard normals (default: drawn from
    ``generator``), scaled by ``sigma`` here.
    """
    r, p, d = params.projections.shape
    w = params.projections.reshape(r * p, d)
    proj = torch.matmul(x.to(torch.float32), w.T)
    if noise is None:
        noise = torch.randn(proj.shape, generator=generator,
                            device=proj.device, dtype=torch.float32)
    proj = proj + sigma * noise
    return _pack_codes(proj > 0, r, p)


def private_prp_codes(
    generator: Optional[torch.Generator], params: lsh.LSHParams, z: Tensor,
    sigma: float, e_s: Optional[Tensor] = None, e_t: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Both antithetic code sets from ONE shared-pass Gaussian release.

    The augmented pair shares its padding coordinate: with ``s = z . w_z``
    and ``t = pad * w_pad`` per (row, plane),

        proj(aug(z)) = s + t,      proj(aug(-z)) = t - s.

    The mechanism makes one projection pass, releases the noisy pair
    ``(s~, t~) = (s + sigma e_s, t + sigma e_t)`` with *independent* normal
    components, and derives both code sets as post-processing:

        codes_pos from  s~ + t~ > 0,      codes_neg from  t~ - s~ > 0,

    so the antithetic pairing survives noise exactly as in the clean path
    (``v_pos + v_neg = 2 t~``) and the paired insert costs ONE
    ``(eps, delta)`` release, not the 2x of two independent draws on two
    separate projections (which also break the pairing).

    The release must be full rank on ``(s, t)``. One scalar draw on
    ``proj(aug(z))`` reused for both sides makes the pair sum ``v_pos +
    v_neg = 2t`` EXACTLY: the noise cancels out of the antithetic
    combination and the padding projection is released noiselessly (a
    boundary point with ``pad = 0`` yields complementary code sets for
    sure, so an adversary separates it from interior points with
    probability 1: unbounded privacy loss). Independent noise on the two
    components keeps every observable linear combination noisy.

    Args:
      generator: draws ``e_s`` and ``e_t`` (in that order) when not given.
      params: hash parameters over the augmented ``d + 2`` space.
      z: ``(..., d)`` pre-scaled points (``|z| <= 1``; NOT augmented).
      sigma: per-component Gaussian scale (:func:`gaussian_sigma` at the
        input-space sensitivity ``|aug(z) - aug(z')| <= 2``).
      e_s, e_t: the ``(..., R*p)`` standard normals of the two components.

    Returns:
      ``(codes_pos, codes_neg, noisy_t)``: the two ``(..., R)`` int32 code
      sets and the ``(..., R*p)`` noisy padding projection ``t~``. At
      ``sigma = 0`` both sides equal ``lsh.prp_codes`` up to fp sign ties
      (the split ``s + t`` sum against the augmented matmul).
    """
    r, p, d_aug = params.projections.shape
    d = d_aug - 2
    if z.shape[-1] != d:
        raise ValueError(f"z has dim {z.shape[-1]}; params hash the "
                         f"augmented {d_aug}-dim space so z must be {d}-dim")
    z = z.to(torch.float32)
    sq = torch.sum(z * z, dim=-1, keepdim=True)
    pad = torch.sqrt(torch.clamp(1.0 - sq, min=0.0))  # (..., 1)
    w = params.projections.reshape(r * p, d_aug)
    s_part = torch.matmul(z, w[:, :d].T)  # (..., R*p)
    t_part = pad * w[:, d + 1]  # (..., R*p)
    if e_s is None:
        e_s = torch.randn(s_part.shape, generator=generator,
                          device=s_part.device, dtype=torch.float32)
    if e_t is None:
        e_t = torch.randn(t_part.shape, generator=generator,
                          device=t_part.device, dtype=torch.float32)
    noisy_s = s_part + sigma * e_s
    noisy_t = t_part + sigma * e_t
    cpos = _pack_codes(noisy_s + noisy_t > 0, r, p)
    cneg = _pack_codes(noisy_t - noisy_s > 0, r, p)
    return cpos, cneg, noisy_t


def private_prp_insert(
    generator: Optional[torch.Generator], sk: sketch_lib.Sketch,
    params: lsh.LSHParams, z: Tensor, sigma: float,
    e_s: Optional[Tensor] = None, e_t: Optional[Tensor] = None,
) -> sketch_lib.Sketch:
    """PRP insert under the private-projection mechanism: one shared-pass
    Gaussian release per example (:func:`private_prp_codes`), both bucket
    updates post-processing of it, so the insert costs one JL release."""
    cpos, cneg, _ = private_prp_codes(generator, params, z, sigma, e_s, e_t)
    return sketch_lib.prp_update(sk, cpos, cneg)
