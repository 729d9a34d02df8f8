"""Activation taps: name tap points and build the tap-emitting decode step
(port of ``repro.telemetry.taps``).

A tap point is ``(model, cycle index)``, or ``(model, layer index)`` for a
config with a ``layer_pattern``: the residual stream after that cycle or
layer, pooled over the token axis with ``probes.pool_hidden``.
:func:`tapped_decode_fn` returns the decode step that also yields the pooled
features and a per-lane probe target from the same step's logits, so one
step gives a ``(features, target)`` pair per active lane and the raw
activation can be dropped right after the sketch insert. The extra outputs
copy values the untapped step computes anyway: sampled tokens are the same
with taps on or off.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import probes
from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

_TARGETS = ("entropy", "max_logprob", "margin")
_POOLS = ("mean", "last")


@dataclasses.dataclass(frozen=True)
class TapConfig:
    """Tap points for one served model.

    Attributes:
      model: routing label; the bridge keys tenant slots by ``(model,
        layer)``, so engines of different models can share one gateway.
      layers: cycle indices to tap, or a pattern config's layers (``()`` =
        every one).
      pool: token-axis pooling (``probes.pool_hidden``); one decode token
        makes ``mean`` and ``last`` coincide.
      target: scalar probe target from the step's logits (``entropy |
        max_logprob | margin``).
    """

    model: str
    layers: Tuple[int, ...] = ()
    pool: str = "last"
    target: str = "entropy"

    def __post_init__(self):
        if self.pool not in _POOLS:
            raise ValueError(f"unknown pool {self.pool!r}; use {_POOLS}")
        if self.target not in _TARGETS:
            raise ValueError(
                f"unknown target {self.target!r}; use {_TARGETS}")

    def resolve_layers(self, cfg: ModelConfig) -> Tuple[int, ...]:
        """Concrete tap cycles (a pattern config's layers) for ``cfg``
        (``()`` means all)."""
        if not self.layers:
            return tuple(range(cfg.tap_points))
        return model._check_tap_layers(self.layers, cfg)


@dataclasses.dataclass
class TapBatch:
    """One engine step's taps, on the host.

    ``feats[j, i]`` is lane ``i``'s pooled hidden state at tap layer ``j``;
    ``mask[i]`` marks lanes that carried a request this step (idle lanes
    decode a dummy token: their rows must be dropped before any insert).
    """

    model: str
    step: int
    feats: np.ndarray      # (num_taps, B, d) float32
    targets: np.ndarray    # (B,) float32
    mask: np.ndarray       # (B,) bool

    @property
    def num_taps(self) -> int:
        return self.feats.shape[0]

    def active(self) -> Tuple[np.ndarray, np.ndarray]:
        """(feats (num_taps, n_active, d), targets (n_active,))."""
        return self.feats[:, self.mask, :], self.targets[self.mask]


def probe_target(logits: Tensor, kind: str) -> Tensor:
    """Per-example f32 probe target from logits ``(B, vocab)``: ``entropy``
    (predictive uncertainty), ``max_logprob`` (confidence) or ``margin``
    (top-1 minus top-2 logit)."""
    logits = logits.to(torch.float32)
    if kind == "entropy":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)
    if kind == "max_logprob":
        return torch.max(torch.log_softmax(logits, dim=-1), dim=-1).values
    if kind == "margin":
        top2 = torch.topk(logits, 2, dim=-1).values
        return top2[..., 0] - top2[..., 1]
    raise ValueError(f"unknown target {kind!r}; use {_TARGETS}")


def _pool(resid: Tensor, pool: str) -> Tensor:
    """``(num_taps, B, S, d)`` -> ``(num_taps, B, d)``."""
    return torch.stack([probes.pool_hidden(h, pool) for h in resid])


def tapped_decode_fn(params, cfg: ModelConfig, tap: TapConfig):
    """The tap-emitting decode step of a serving engine:
    ``step(state, tokens, pos) -> (logits, new_state, feats (num_taps, B, d)
    float32, targets (B,) float32)``; logits and state equal the untapped
    ``model.decode_step``'s bit for bit."""
    layers_idx = tap.resolve_layers(cfg)

    def step(state, toks, pos):
        logits, new_state, resid = model.decode_step(
            params, cfg, state, {"tokens": toks}, pos, tap_layers=layers_idx)
        return (logits, new_state, _pool(resid, tap.pool),
                probe_target(logits, tap.target))

    return step


def extract_tap_features(params, cfg: ModelConfig, batch, tap: TapConfig
                         ) -> Tuple[Tensor, Tensor]:
    """Offline taps over a token batch: ``(feats (num_taps, B, d) float32,
    targets (B,) float32)``, the targets from the last position's logits
    (the decode step's next-token view); a ``taps.extract`` span while
    :mod:`repro_torch.tracing` is on."""
    layers_idx = tap.resolve_layers(cfg)
    with tracing.span("taps.extract"):
        hidden, resid = model.forward_taps(params, cfg, batch, layers_idx)
        logits = layers.unembed(model.unembed_table(params, cfg),
                                hidden[:, -1, :], hidden.dtype)
        return _pool(resid, tap.pool), probe_target(logits, tap.target)
