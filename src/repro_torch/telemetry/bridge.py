"""TelemetryBridge: tap batches -> gateway ingest, one tenant slot per
``(model, layer)`` (port of ``repro.telemetry.bridge``).

The bridge buffers :class:`~repro_torch.telemetry.taps.TapBatch` samples per
model; every ``window`` samples it standardizes each tap layer's features
under that slot's FROZEN moments (``probes.probe_rows``), submits the rows
as ordinary :class:`~repro_torch.serve.storm_gateway.IngestRequest` traffic
and drains the gateway between engine steps. The first flushed window of a
slot is its calibration window: its moments freeze, so the slot's counters
form one sketch. After any number of flushes a slot's counters equal the
offline ``probes.sketch_features(..., moments=frozen)`` build on the same
rows bit for bit (the rows are standardized on the gateway's device by the
same ops, and counters are order-free integer sums), and a probe fitted
from the served counters equals the offline ``fit_probe_many`` bit for bit.

While :mod:`repro_torch.tracing` is on, a flush is a span
(``bridge.flush``) holding each tap's standardization
(``bridge.standardize``), the readback of its rows (``bridge.readback``)
and the gateway's drain (``bridge.drain``), inside which the gateway's own
spans nest.

The gateway is duck-typed (``submit``, ``run_until_idle``, ``sketch_of``,
``params``, ``tenants``, ``ticks``, ``paired``): both
:class:`~repro_torch.serve.storm_gateway.StormGateway` and
:class:`~repro_torch.serve.tiered_gateway.TieredStormGateway` work.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import probes, sketch as sketch_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serve.storm_gateway import FitRequest, IngestRequest
from repro_torch.telemetry.taps import TapBatch, TapConfig

# Telemetry rids live far above interactive traffic, so gateway logs tell
# the producers apart.
_RID_BASE = 1 << 40


class _ModelTaps:
    """Per-model registration: layer -> slot map and the sample buffer."""

    def __init__(self, tap: TapConfig, layers: Tuple[int, ...],
                 slots: Tuple[int, ...], d_model: int):
        self.tap = tap
        self.layers = layers
        self.slots = slots                  # slots[j] serves layers[j]
        self.d_model = d_model
        self.feats: List[np.ndarray] = []   # (num_taps, n_i, d) chunks
        self.targets: List[np.ndarray] = []
        self.buffered = 0

    def append(self, batch: TapBatch) -> None:
        feats, targets = batch.active()
        if feats.shape[0] != len(self.layers):
            raise ValueError(
                f"tap batch for {self.tap.model!r} carries {feats.shape[0]} "
                f"layers; registered {len(self.layers)}"
            )
        if targets.size == 0:
            return
        self.feats.append(np.asarray(feats, np.float32))
        self.targets.append(np.asarray(targets, np.float32))
        self.buffered += targets.size

    def take(self) -> Tuple[np.ndarray, np.ndarray]:
        feats = np.concatenate(self.feats, axis=1)
        targets = np.concatenate(self.targets)
        self.feats, self.targets, self.buffered = [], [], 0
        return feats, targets


class TelemetryBridge:
    """Feed live activation taps into a STORM gateway's ingest path."""

    def __init__(self, gateway, probe_config: Optional[probes.ProbeConfig] =
                 None, *, window: int = 256, auto_flush: bool = True):
        """Args:
          gateway: a paired (PRP) gateway whose hash family has
            ``dim == d_model + 3`` (features, target column, the two PRP
            augmentation coordinates).
          probe_config: sketch knobs; ``rows``/``planes`` must match the
            gateway's family.
          window: samples per model buffered before an automatic flush (a
            threshold: the flush takes everything buffered).
          auto_flush: flush from the tap sink once ``window`` is crossed;
            ``False`` leaves flushing to the caller.
        """
        if getattr(gateway, "paired", None) is not True:
            raise ValueError(
                "telemetry needs a paired (PRP) gateway — probe rows are "
                "PRP regression inserts"
            )
        self.gateway = gateway
        self.config = probe_config or probes.ProbeConfig()
        if (self.config.rows != gateway.params.rows
                or self.config.planes != gateway.params.planes):
            raise ValueError(
                f"probe_config rows/planes ({self.config.rows}, "
                f"{self.config.planes}) disagree with the gateway hash "
                f"family ({gateway.params.rows}, {gateway.params.planes})"
            )
        self.device = gateway.params.projections.device
        self.window = window
        self.auto_flush = auto_flush
        self.monitor = None                  # a DriftMonitor attaches itself
        self._models: Dict[str, _ModelTaps] = {}
        self._slot_key: List[Tuple[str, int]] = []   # slot -> (model, layer)
        self._moments: List[Optional[probes.ProbeMoments]] = []
        self._rows_ingested: List[int] = []
        self._windows: List[int] = []
        self._last_flush_tick: List[Optional[int]] = []
        self._rids = itertools.count(_RID_BASE)
        self.flushes = 0

    # -- registration -------------------------------------------------------

    def register(self, tap: TapConfig, cfg: ModelConfig) -> Callable:
        """Claim one gateway tenant slot per tap layer, in registration
        order; return the engine's ``tap_sink``."""
        if tap.model in self._models:
            raise ValueError(f"model {tap.model!r} already registered")
        layers = tap.resolve_layers(cfg)
        want = cfg.d_model + 3
        if self.gateway.params.dim != want:
            raise ValueError(
                f"gateway hash family has dim {self.gateway.params.dim}; "
                f"taps of {tap.model!r} (d_model={cfg.d_model}) need "
                f"{want} (= d_model + target column + PRP augmentation)"
            )
        base = len(self._slot_key)
        if base + len(layers) > self.gateway.tenants:
            raise ValueError(
                f"not enough gateway tenants: {tap.model!r} needs "
                f"{len(layers)} slots at offset {base} but the gateway "
                f"has {self.gateway.tenants}"
            )
        slots = tuple(range(base, base + len(layers)))
        for layer in layers:
            self._slot_key.append((tap.model, layer))
            self._moments.append(None)
            self._rows_ingested.append(0)
            self._windows.append(0)
            self._last_flush_tick.append(None)
        self._models[tap.model] = _ModelTaps(tap, layers, slots, cfg.d_model)
        return self.on_taps

    def slot_of(self, model: str, layer: int) -> int:
        """Gateway tenant slot serving tap ``(model, layer)``."""
        try:
            return self._slot_key.index((model, layer))
        except ValueError:
            raise KeyError(f"no tap registered for ({model!r}, {layer})")

    @property
    def slots(self) -> List[Tuple[str, int]]:
        """Slot -> ``(model, layer)`` in gateway-tenant order."""
        return list(self._slot_key)

    # -- the sink -----------------------------------------------------------

    def on_taps(self, batch: TapBatch) -> None:
        """Engine tap sink: buffer one step's active-lane samples; crossing
        ``window`` flushes (between engine steps: the engine calls the sink
        after its decode step returned)."""
        reg = self._models.get(batch.model)
        if reg is None:
            raise KeyError(f"model {batch.model!r} is not registered")
        reg.append(batch)
        if self.auto_flush and reg.buffered >= self.window:
            self.flush(batch.model)

    def flush(self, model: Optional[str] = None, drain: bool = True) -> int:
        """Standardize the buffered samples and ingest them; returns the
        rows sent. A slot's first flush computes and freezes its moments.
        ``drain=True`` runs the gateway until idle, then notifies an
        attached monitor (one observed window)."""
        with tracing.span("bridge.flush"):
            return self._flush(model, drain)

    def _flush(self, model: Optional[str], drain: bool) -> int:
        names = [model] if model is not None else list(self._models)
        total = 0
        for name in names:
            reg = self._models[name]
            if reg.buffered == 0:
                continue
            feats, targets = reg.take()
            # Standardize on the gateway's device with probe_rows' torch
            # ops: the offline comparator runs the same ops there.
            feats_t = torch.from_numpy(feats).to(self.device)
            targets_t = torch.from_numpy(targets).to(self.device)
            for j, slot in enumerate(reg.slots):
                with tracing.span("bridge.standardize"):
                    rows, moments = probes.probe_rows(
                        feats_t[j], targets_t, self.config,
                        moments=self._moments[slot])
                if self._moments[slot] is None:
                    self._moments[slot] = moments
                with tracing.span("bridge.readback"):
                    z = rows.cpu().numpy()
                self.gateway.submit(IngestRequest(
                    rid=next(self._rids), tenant=slot, z=z))
                self._rows_ingested[slot] += rows.shape[0]
                self._windows[slot] += 1
                total += rows.shape[0]
        if total == 0:
            return 0
        self.flushes += 1
        if drain:
            with tracing.span("bridge.drain"):
                self.gateway.run_until_idle()
            for name in names:
                for slot in self._models[name].slots:
                    self._last_flush_tick[slot] = self.gateway.ticks
            if self.monitor is not None:
                self.monitor.observe()
        return total

    # -- probe surface ------------------------------------------------------

    def moments_of(self, model: str, layer: int) -> probes.ProbeMoments:
        m = self._moments[self.slot_of(model, layer)]
        if m is None:
            raise ValueError(
                f"tap ({model!r}, {layer}) has no frozen moments yet — "
                f"no window has been flushed"
            )
        return m

    def probe_state(self, model: str, layer: int) -> probes.ProbeState:
        """A tap's served counters (an int32 copy: the gateway updates its
        bank in place) and frozen moments as a fit-ready state."""
        slot = self.slot_of(model, layer)
        m = self.moments_of(model, layer)
        sk = self.gateway.sketch_of(slot)
        sk = sketch_lib.Sketch(
            counts=sk.counts.to(self.device, torch.int32, copy=True),
            n=sk.n.to(self.device, torch.int32, copy=True))
        return probes.ProbeState(
            sketch=sk, params=self.gateway.params,
            x_mean=m.x_mean, x_scale=m.x_scale,
            y_mean=m.y_mean, y_scale=m.y_scale, scale=m.scale, count=sk.n,
        )

    def probe_states(self) -> List[probes.ProbeState]:
        """Every flushed tap's state, in slot order (all share the
        gateway's one hash family)."""
        return [self.probe_state(m, l) for m, l in self._slot_key
                if self._moments[self.slot_of(m, l)] is not None]

    def fit_probes(self, gen: Optional[torch.Generator], **fit_kwargs
                   ) -> probes.FittedProbeMany:
        """Refresh every tap's value head from the SERVED counters: one
        ``probes.fit_probe_many`` over all flushed slots on the gateway's
        device (the offline fit of the same states, bit for bit)."""
        states = self.probe_states()
        if not states:
            raise ValueError("no flushed taps to fit probes from")
        d_model = states[0].x_mean.shape[0]
        fit_kwargs.setdefault("device", self.device)
        return probes.fit_probe_many(gen, states, d_model, **fit_kwargs)

    def fit_request(self, rid: int, **knobs) -> FitRequest:
        """A gateway-side :class:`FitRequest` over every flushed slot (the
        gateway trains the cohort between ticks and returns iterate-space
        thetas; :meth:`moments_of` un-standardizes them)."""
        tenants = [self.slot_of(m, l) for m, l in self._slot_key
                   if self._moments[self.slot_of(m, l)] is not None]
        if not tenants:
            raise ValueError("no flushed taps to fit")
        return FitRequest(rid=rid, tenants=tenants, **knobs)

    # -- stats --------------------------------------------------------------

    def telemetry_stats(self) -> dict:
        """Host-side telemetry state for monitoring and the wire's stats
        frame."""
        stats = {
            "slots": [
                {
                    "model": m,
                    "layer": layer,
                    "tenant": slot,
                    "windows": self._windows[slot],
                    "rows_ingested": self._rows_ingested[slot],
                    "moments_frozen": self._moments[slot] is not None,
                    "last_flush_tick": self._last_flush_tick[slot],
                }
                for slot, (m, layer) in enumerate(self._slot_key)
            ],
            "models": {
                name: {"buffered": reg.buffered,
                       "layers": list(reg.layers),
                       "target": reg.tap.target,
                       "pool": reg.tap.pool}
                for name, reg in self._models.items()
            },
            "window": self.window,
            "flushes": self.flushes,
        }
        if self.monitor is not None:
            stats["drift"] = self.monitor.status()
        return stats
