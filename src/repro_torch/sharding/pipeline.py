"""GPipe pipeline parallelism over a mesh axis (port of
``repro.sharding.pipeline``).

Stages own contiguous groups of layers; microbatches stream through them.
The reference writes the schedule as a ``shard_map`` with a
``collective_permute`` along the ``pipe`` axis; the port's single
controller runs the same schedule over the axis's devices, in one thread:
a step's stages run one after another, and the hand-over to the next
stage is a copy to its device (reported as a ``collective-permute`` to
``mesh.note_transfer``; the last stage's outputs as an ``all-gather``). Model-agnostic: any ``fn(stage_params, x)``
block function works.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Union

import torch

from repro_torch.sharding.mesh import Mesh, note_transfer
from repro_torch.train import tree as tree_lib

Tensor = torch.Tensor


def pipeline_forward(fn: Callable[[Any, Tensor], Tensor],
                     stage_params: Union[Tensor, Sequence[Any]],
                     x: Tensor, mesh: Mesh, axis: str = "pipe") -> Tensor:
    """Run the microbatches ``x (M, micro_batch, ...)`` through every stage
    of ``axis`` and return the last stage's outputs ``(M, ...)`` on the
    mesh's first device.

    ``stage_params`` is a tensor whose leading dim is the number of stages
    (the reference's layout) or a sequence of one tree per stage (an LM's
    stage: a list of cycles); stage ``s``'s parameters live on the axis's
    device ``s``, and ``fn(stage_params[s], h)`` applies its layers.

    The GPipe schedule: with ``S`` stages and ``M`` microbatches, step
    ``t`` runs microbatch ``t - s`` on stage ``s``; stage 0 takes ``x[t]``,
    every other stage the previous stage's output of step ``t - 1``, and
    the last stage writes its output. ``M + S - 1`` steps; the bubble
    fraction (a stage idle at a step) is ``(S - 1) / (M + S - 1)``. The
    reference computes ``fn`` at the idle steps too and masks the result
    to zero; the port skips them, which gives the same outputs.
    """
    devs = mesh.along(axis)
    n_stage = len(devs)
    if len(stage_params) != n_stage:
        raise ValueError(f"{len(stage_params)} stages of parameters for "
                         f"mesh axis {axis!r} of {n_stage} devices")
    m = x.shape[0]
    if m < 1:
        raise ValueError("the pipeline needs at least one microbatch")
    local = [tree_lib.tree_map(lambda p, d=dev: p.to(d), stage_params[s])
             for s, dev in enumerate(devs)]
    outputs: List[Tensor] = [None] * m
    bufs: List[Tensor] = [None] * n_stage  # each stage's output, last step
    for t in range(m + n_stage - 1):
        nxt = [None] * n_stage
        for s, dev in enumerate(devs):
            mb = t - s
            if not 0 <= mb < m:
                continue  # a bubble
            inp = x[mb] if s == 0 else bufs[s - 1]
            if s:
                note_transfer("collective-permute", [inp])
            nxt[s] = fn(local[s], inp.to(dev))
            if s == n_stage - 1:
                if s:
                    note_transfer("all-gather", [nxt[s]])
                outputs[mb] = nxt[s].to(mesh.first)
        bufs = nxt
    return torch.stack(outputs)


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The share of stage-steps a GPipe schedule leaves idle."""
    return (stages - 1) / (microbatches + stages - 1)
