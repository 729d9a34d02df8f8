"""Training loop with fault tolerance, auto-resume and straggler telemetry
(port of ``repro.train.trainer``, the same control flow).

  * checkpoints every ``ckpt_every`` steps and at the end (atomic + CRC,
    keep-k) — a preempted job restarts with ``resume=True`` and continues
    from the newest *intact* checkpoint, replaying the data stream from the
    step counter (``data_for_step`` is deterministic in the step).
  * a per-step wall-time watchdog tracks a rolling median; steps slower than
    ``straggler_factor`` x median are recorded as stragglers. ``dt`` is on
    the host clock, and reading the loss (``float``) is the step's sync.
  * on a failed step (an exception, or a NaN loss with ``halt_on_nan``) the
    loop restores the last checkpoint instead of crashing. The step updates
    the state in place, so a failed step may have written into it: the
    loop never goes on from that state, it restores from disk (as the
    reference does) or raises. A CUDA error is sticky, so on the card the
    restore-on-exception branch cannot save a run: it only re-raises later.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    halt_on_nan: bool = True


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_loss: float
    losses: List[float]
    straggler_steps: List[int]
    resumed_from: Optional[int]
    restores: int


def train(gen: Optional[torch.Generator], cfg: ModelConfig,
          tcfg: ts.TrainConfig, loop: LoopConfig,
          data_for_step: Callable[[int], Dict[str, torch.Tensor]],
          resume: bool = True, step_fn: Optional[Callable] = None,
          device: DeviceLike = None) -> LoopReport:
    """Run the training loop from a state initialized from ``gen`` on
    ``device`` (``None``: the card). ``step_fn(state, batch) -> (state,
    metrics)`` defaults to ``train_step``. ``data_for_step(step)`` must be
    deterministic in ``step`` — that is what makes restart-replay exact."""
    state = ts.init_state(gen, cfg, tcfg, device=device)
    start_step = 0
    resumed_from = None

    if resume and loop.ckpt_dir:
        restored = checkpoint.restore(loop.ckpt_dir, state)
        if restored is not None:
            start_step, state, _ = restored
            resumed_from = start_step

    fn = step_fn or (lambda s, b: ts.train_step(s, b, cfg, tcfg))

    losses: List[float] = []
    stragglers: List[int] = []
    durations: List[float] = []
    restores = 0

    step = start_step
    while step < loop.total_steps:
        batch = data_for_step(step)
        t0 = time.perf_counter()
        try:
            new_state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
        except Exception:
            # The step failed (out of memory, a lost device): restore, retry.
            if loop.ckpt_dir:
                restored = checkpoint.restore(loop.ckpt_dir, state)
                if restored is not None:
                    step, state, _ = restored
                    restores += 1
                    continue
            raise
        dt = time.perf_counter() - t0

        if np.isnan(loss) and loop.halt_on_nan:
            if loop.ckpt_dir and checkpoint.available_steps(loop.ckpt_dir):
                step, state, _ = checkpoint.restore(loop.ckpt_dir, state)
                restores += 1
                continue
            raise FloatingPointError(f"NaN loss at step {step}")

        state = new_state
        losses.append(loss)
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > loop.straggler_factor * med:
            stragglers.append(step)

        step += 1
        if loop.ckpt_dir and step % loop.ckpt_every == 0:
            checkpoint.save(loop.ckpt_dir, step, state, keep=loop.keep)

    if loop.ckpt_dir:
        checkpoint.save(loop.ckpt_dir, step, state, keep=loop.keep)
    return LoopReport(
        steps_run=step - start_step,
        final_loss=losses[-1] if losses else float("nan"),
        losses=losses,
        straggler_steps=stragglers,
        resumed_from=resumed_from,
        restores=restores,
    )
