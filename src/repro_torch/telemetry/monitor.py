"""Drift detection and continuous probe refresh over live gateway counters
(port of ``repro.telemetry.monitor``).

STORM counters are linear: a tenant's cumulative table after window ``t``
minus its table after window ``t - 1`` IS the sketch of window ``t``'s rows
alone, so the :class:`DriftMonitor` never stores activations. It snapshots
counter tables at window boundaries and scores each window's delta against
a frozen reference delta: per sketch row, ``counts / (2n)`` is a frequency
distribution over ``2^planes`` buckets, compared by mean total variation
(``"tv"``, :func:`counter_distance`) or smoothed symmetric KL (``"kl"``,
:func:`counter_kl`). The alarm threshold calibrates itself on the first
in-distribution windows (``mean + margin * std``, with a floor), unless an
explicit ``threshold`` is given.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

_THRESHOLD_FLOOR = 1e-3


def window_delta(prev_counts: torch.Tensor, cur_counts: torch.Tensor
                 ) -> torch.Tensor:
    """The counter table of ONE window from two cumulative snapshots."""
    return cur_counts.to(torch.int64) - prev_counts.to(torch.int64)


def _probabilities(counts, n: float, paired: bool, smoothing: float = 0.0):
    """``counts`` a numpy array, or a tensor on any device (copied to the
    host as float64, as numpy of a jax Array copies it in the reference)."""
    per = 2.0 if paired else 1.0
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().to("cpu", torch.float64).numpy()
    c = np.asarray(counts, np.float64) + smoothing
    return c / (per * n + smoothing * c.shape[-1])


def counter_distance(a_counts, a_n, b_counts, b_n, *, paired: bool = True
                     ) -> float:
    """Mean-over-rows total variation distance between two counter tables
    (``counts / (2n)`` per row for paired inserts). Empty tables score 0:
    no evidence is not drift."""
    a_n, b_n = float(a_n), float(b_n)
    if a_n <= 0 or b_n <= 0:
        return 0.0
    pa = _probabilities(a_counts, a_n, paired)
    pb = _probabilities(b_counts, b_n, paired)
    return float(np.mean(0.5 * np.sum(np.abs(pa - pb), axis=-1)))


def counter_kl(a_counts, a_n, b_counts, b_n, *, paired: bool = True,
               smoothing: float = 0.5) -> float:
    """Mean-over-rows symmetric KL ``0.5 (KL(a||b) + KL(b||a))`` between two
    counter tables, with ``smoothing`` pseudo-counts per bucket so it stays
    finite. Empty tables score 0. Unbounded: compare only against a
    threshold calibrated with the same scorer."""
    a_n, b_n = float(a_n), float(b_n)
    if a_n <= 0 or b_n <= 0:
        return 0.0
    pa = _probabilities(a_counts, a_n, paired, smoothing)
    pb = _probabilities(b_counts, b_n, paired, smoothing)
    sym = 0.5 * np.sum((pa - pb) * (np.log(pa) - np.log(pb)), axis=-1)
    return float(np.mean(sym))


_SCORES = {"tv": counter_distance, "kl": counter_kl}


class _SlotTrack:
    """Per-slot drift state: snapshot, reference delta, null calibration."""

    def __init__(self):
        self.prev_counts: Optional[np.ndarray] = None
        self.prev_n: int = 0
        self.ref_counts: Optional[np.ndarray] = None  # summed ref deltas
        self.ref_n: int = 0
        self.ref_seen: int = 0
        self.null_scores: List[float] = []
        self.threshold: Optional[float] = None
        self.windows: int = 0
        self.last_score: Optional[float] = None
        self.flagged: bool = False
        self.flagged_at: Optional[int] = None


class DriftMonitor:
    """Reference-vs-rolling-window drift detector over bridge slots.

    The bridge calls :meth:`observe` after each drained flush, so a window
    is one flush. Per slot, the first ``reference_windows`` windows merge
    into the reference, the next ``calibration_windows`` set the null
    threshold, and every later window is scored and flagged above it.
    ``refresh_every`` retrains all probes from the served counters every
    that many scored windows (``bridge.fit_probes``), drawing from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, bridge, *, reference_windows: int = 1,
                 calibration_windows: int = 3,
                 threshold: Optional[float] = None, margin: float = 3.0,
                 refresh_every: Optional[int] = None, seed: int = 0,
                 score: str = "tv"):
        if reference_windows < 1:
            raise ValueError("need at least one reference window")
        if score not in _SCORES:
            raise ValueError(
                f"unknown score {score!r}; choose from {sorted(_SCORES)}")
        if threshold is None and calibration_windows < 1:
            raise ValueError(
                "auto-thresholding needs at least one calibration window "
                "(or pass an explicit threshold)")
        self.bridge = bridge
        self.reference_windows = reference_windows
        self.calibration_windows = 0 if threshold is not None \
            else calibration_windows
        self.fixed_threshold = threshold
        self.margin = margin
        self.score_name = score
        self._score_fn = _SCORES[score]
        self.refresh_every = refresh_every
        self._tracks: Dict[int, _SlotTrack] = {}
        self._gen = torch.Generator(device=bridge.device).manual_seed(seed)
        self.refreshes = 0
        self.last_fit = None
        self._scored_windows = 0
        bridge.monitor = self

    def _track(self, slot: int) -> _SlotTrack:
        if slot not in self._tracks:
            self._tracks[slot] = _SlotTrack()
        return self._tracks[slot]

    def observe(self) -> None:
        """Score one window boundary (called by the bridge after a flush)."""
        scored = False
        for slot in range(len(self.bridge.slots)):
            sk = self.bridge.gateway.sketch_of(slot)
            counts = sk.counts.cpu().numpy().astype(np.int64)
            n = int(sk.n)
            tr = self._track(slot)
            if tr.prev_counts is None:
                if n > 0:  # first sight of this slot: snapshot its data
                    tr.prev_counts, tr.prev_n = counts, n
                continue
            if n == tr.prev_n:
                continue        # no traffic for this slot this flush
            delta = counts - tr.prev_counts
            delta_n = n - tr.prev_n
            tr.prev_counts, tr.prev_n = counts, n
            tr.windows += 1
            if tr.ref_seen < self.reference_windows:
                tr.ref_counts = delta if tr.ref_counts is None \
                    else tr.ref_counts + delta
                tr.ref_n += delta_n
                tr.ref_seen += 1
                continue
            score = self._score_fn(tr.ref_counts, tr.ref_n, delta, delta_n,
                                   paired=self.bridge.gateway.paired)
            tr.last_score = score
            if tr.threshold is None and self.fixed_threshold is None:
                tr.null_scores.append(score)
                if len(tr.null_scores) >= self.calibration_windows:
                    mean = float(np.mean(tr.null_scores))
                    std = float(np.std(tr.null_scores))
                    tr.threshold = max(mean + self.margin * std,
                                       mean * (1.0 + 0.25 * self.margin),
                                       _THRESHOLD_FLOOR)
                continue
            thr = self.fixed_threshold if self.fixed_threshold is not None \
                else tr.threshold
            scored = True
            if score > thr and not tr.flagged:
                tr.flagged = True
                tr.flagged_at = tr.windows
        if scored:
            self._scored_windows += 1
            if (self.refresh_every
                    and self._scored_windows % self.refresh_every == 0):
                self.refresh()

    def refresh(self, gen: Optional[torch.Generator] = None, **fit_kwargs):
        """Retrain every flushed probe from the live served counters."""
        self.last_fit = self.bridge.fit_probes(
            gen if gen is not None else self._gen, **fit_kwargs)
        self.refreshes += 1
        return self.last_fit

    def flagged(self) -> List[dict]:
        """Slots currently flagged as drifted."""
        out = []
        for slot, (mdl, layer) in enumerate(self.bridge.slots):
            tr = self._tracks.get(slot)
            if tr is not None and tr.flagged:
                out.append({"model": mdl, "layer": layer, "tenant": slot,
                            "score": tr.last_score,
                            "flagged_at_window": tr.flagged_at})
        return out

    def status(self) -> dict:
        """Monitor state for ``telemetry_stats()`` and the wire's stats
        frame."""
        slots = []
        for slot, (mdl, layer) in enumerate(self.bridge.slots):
            tr = self._tracks.get(slot) or _SlotTrack()
            thr = self.fixed_threshold if self.fixed_threshold is not None \
                else tr.threshold
            slots.append({
                "model": mdl, "layer": layer, "tenant": slot,
                "windows": tr.windows,
                "reference_windows": tr.ref_seen,
                "threshold": thr,
                "score": tr.last_score,
                "flagged": tr.flagged,
                "flagged_at_window": tr.flagged_at,
            })
        return {
            "slots": slots,
            "any_flagged": any(s["flagged"] for s in slots),
            "refreshes": self.refreshes,
            "scored_windows": self._scored_windows,
            "score": self.score_name,
        }
