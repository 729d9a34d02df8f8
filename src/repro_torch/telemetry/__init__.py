"""Live LM telemetry: activation taps -> sketch gateway -> online probes
(port of ``repro.telemetry``; DESIGN.md §14).

The serving engine's decode step emits per-layer pooled hidden states
(:mod:`repro_torch.telemetry.taps`), a
:class:`~repro_torch.telemetry.bridge.TelemetryBridge` standardizes them
under frozen reference moments and feeds them to a STORM gateway as
ordinary ingest (one tenant slot per ``(model, layer)`` tap), and a
:class:`~repro_torch.telemetry.monitor.DriftMonitor` scores rolling counter
windows against a reference and refreshes probes from the served counters.
"""

from repro_torch.telemetry.bridge import TelemetryBridge
from repro_torch.telemetry.monitor import (
    DriftMonitor, counter_distance, counter_kl, window_delta,
)
from repro_torch.telemetry.taps import (
    TapBatch, TapConfig, probe_target, tapped_decode_fn,
)

__all__ = [
    "DriftMonitor",
    "TapBatch",
    "TapConfig",
    "TelemetryBridge",
    "counter_distance",
    "counter_kl",
    "probe_target",
    "tapped_decode_fn",
    "window_delta",
]
