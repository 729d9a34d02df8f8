"""Batched serving engine: continuous batching over fixed decode slots (port
of ``repro.serve.engine``).

  * a fixed number of cache lanes (slots), each at its own position;
  * admission zeroes a free lane's caches and streams the prompt through the
    shared decode step one token per engine step (piggy-backed prefill), so
    new requests join without stalling generations in flight;
  * a finished request frees its lane at once;
  * with a ``TapConfig`` the decode step also emits per-layer pooled hidden
    states and a probe target per lane, handed to ``tap_sink`` (normally a
    ``TelemetryBridge``) every step. Sampled tokens are the same with taps
    on or off.

Host state: ``pos`` and ``next_token`` are numpy arrays that change every
step. They reach the device as one stacked copy per step, made from a
fresh array through a synchronous copy (pageable memory: it waits for the
stream), so mutating them afterwards cannot race a copy still in flight;
the greedy tokens come back in one ``argmax`` read per step that samples
anything.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry.taps import TapBatch, TapConfig, tapped_decode_fn

Tensor = torch.Tensor


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 = greedy


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]


@dataclasses.dataclass
class _Lane:
    req: Optional[Request] = None
    prompt_cursor: int = 0        # next prompt token to feed
    generated: Optional[List[int]] = None

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.prompt_cursor < len(self.req.prompt)


class ServeEngine:
    """Fixed-slot continuous-batching engine on one device."""

    def __init__(self, params: Any, cfg: ModelConfig, slots: int,
                 cache_len: int, seed: int = 0,
                 taps: Optional[TapConfig] = None,
                 tap_sink: Optional[Callable[[TapBatch], None]] = None,
                 device: DeviceLike = None):
        """``params`` must live on ``device`` (``None``: the card, raising
        without one). ``seed`` seeds the sampler of requests with a
        temperature."""
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}; the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = model.init_decode_state(cfg, slots, cache_len,
                                             self.device)
        self.pos = np.zeros(slots, np.int32)
        self.lanes = [_Lane() for _ in range(slots)]
        self.next_token = np.zeros(slots, np.int32)
        self.steps = 0
        self.resets = 0
        self.taps = taps
        self.tap_sink = tap_sink
        if taps is not None:
            self._decode = tapped_decode_fn(params, cfg, taps)
        else:
            self._decode = lambda state, toks, pos: model.decode_step(
                params, cfg, state, {"tokens": toks}, pos)

    # -- lane management ----------------------------------------------------

    def _reset_lane(self, i: int) -> None:
        """Zero lane ``i``'s states in place: every tensor of the tree (KV
        caches, recurrent states, a Mamba state's nested recurrence and
        conv history) is ``(B, ...)``."""
        def zero(node):
            if isinstance(node, torch.Tensor):
                node[i].zero_()
            else:
                for child in (node.values() if isinstance(node, dict)
                              else node):
                    zero(child)

        with torch.no_grad():
            zero(self.state)
        self.pos[i] = 0
        self.resets += 1

    def _admit(self, req: Request) -> bool:
        """Seat ``req`` in a free lane primed with ``prompt[0]``; False if
        every lane is busy (``run`` admits in queue order and stops at the
        first request that does not fit)."""
        for i, lane in enumerate(self.lanes):
            if lane.req is None:
                self._reset_lane(i)
                self.lanes[i] = _Lane(req=req, prompt_cursor=0, generated=[])
                self.next_token[i] = int(req.prompt[0])
                return True
        return False

    def _sample(self, logits: Tensor, temperature: float) -> int:
        """A token from one lane's logits ``(vocab,)`` (temperature > 0)."""
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    def _emit_taps(self, feats: Tensor, targets: Tensor) -> None:
        """Hand one step's taps to the sink with the step's active-lane mask
        (before finished lanes are freed). Prefill steps tap too."""
        active = np.array([l.req is not None for l in self.lanes], bool)
        if not active.any():
            return
        self.tap_sink(TapBatch(
            model=self.taps.model, step=self.steps,
            feats=feats.cpu().numpy(), targets=targets.cpu().numpy(),
            mask=active,
        ))

    # -- main loop ----------------------------------------------------------

    @torch.no_grad()
    def run(self, requests: List[Request], max_steps: int = 100_000
            ) -> List[Completion]:
        for req in requests:
            if len(req.prompt) == 0:
                raise ValueError(
                    f"request {req.rid}: empty prompt — admission primes a "
                    f"lane with prompt[0], so every request needs at least "
                    f"one token"
                )
        queue = list(requests)
        done: List[Completion] = []
        while (queue or any(l.req for l in self.lanes)) and \
                self.steps < max_steps:
            while queue and self._admit(queue[0]):
                queue.pop(0)
            if not any(l.req for l in self.lanes):
                continue
            step_in = torch.from_numpy(
                np.stack([self.next_token, self.pos])).to(self.device)
            out = self._decode(self.state, step_in[0], step_in[1])
            logits, self.state = out[0], out[1]
            self.steps += 1
            if self.taps is not None and self.tap_sink is not None:
                self._emit_taps(out[2], out[3])

            greedy = None
            for i, lane in enumerate(self.lanes):
                if lane.req is None:
                    continue  # idle lane decoded a dummy token; state unused
                self.pos[i] += 1
                if lane.prefilling:
                    lane.prompt_cursor += 1
                    if lane.prompt_cursor < len(lane.req.prompt):
                        self.next_token[i] = int(
                            lane.req.prompt[lane.prompt_cursor])
                        continue
                if lane.req.temperature > 0.0:
                    nxt = self._sample(logits[i], lane.req.temperature)
                else:
                    if greedy is None:  # argmax: the first maximal index
                        greedy = logits.argmax(dim=-1).tolist()
                    nxt = greedy[i]
                lane.generated.append(nxt)
                self.next_token[i] = nxt
                if len(lane.generated) >= lane.req.max_new_tokens or \
                        self.pos[i] >= self.cache_len - 1:
                    done.append(Completion(lane.req.rid, lane.generated))
                    self.lanes[i] = _Lane()
        return done
