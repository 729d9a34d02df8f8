"""The training step: loss, (accumulated) gradients, the AdamW update (port
of ``repro.train.train_step``).

Parameters are leaf tensors with ``requires_grad``; gradients come from
``torch.autograd.grad`` through the remat forward of ``model.train_loss``.
Microbatches run one after another, so the activation peak is one
microbatch's; their gradients are summed in ``grad_dtype`` and scaled by
``1/n`` (:func:`mean_of`), as the reference's scan does. The update runs
in place (``optimizer.apply``): the returned state holds the same tensors
as the one passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tree_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_lib.AdamWConfig = dataclasses.field(
        default_factory=opt_lib.AdamWConfig
    )
    microbatches: int = 1      # grad accumulation steps per update
    aux_weight: float = 0.01   # MoE load-balance loss weight


class TrainStateT(NamedTuple):
    params: Any
    opt: opt_lib.AdamWState
    step: Tensor               # int32, on the host


def trainable(params: Any) -> Any:
    """``params`` with every leaf set to require gradients (in place)."""
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    return params


def init_state(gen: Optional[torch.Generator], cfg: ModelConfig,
               tcfg: TrainConfig, device: DeviceLike = None) -> TrainStateT:
    """Random-init parameters from ``gen`` (``model.init_params``) and a
    fresh optimizer state."""
    params = trainable(model.init_params(gen, cfg, device=device))
    return TrainStateT(params=params, opt=opt_lib.init(tcfg.optimizer, params),
                       step=torch.zeros((), dtype=torch.int32))


def _split_microbatches(batch: Dict[str, Tensor], n: int):
    """``(B, ...)`` -> ``n`` microbatches of ``B/n`` consecutive rows."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
    b = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for i in range(n)]


def _value_and_grad(params: Any, cfg: ModelConfig, batch: Dict[str, Tensor],
                    aux_weight: float):
    leaves = tree_lib.leaves(params)
    loss = model.train_loss(params, cfg, batch, aux_weight)
    # A leaf the loss does not reach (the token table of a model fed
    # embeds) gets zeros, as jax.grad gives it.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def mean_of(loss_sum: Tensor, grads_sum: List[Tensor], params: Any,
            microbatches: int) -> Tuple[Tensor, Any]:
    """The sums over ``microbatches`` scaled by ``1/n``: the mean loss and
    gradients (a tree like ``params``; the gradients scaled in place)."""
    inv = 1.0 / microbatches
    torch._foreach_mul_(grads_sum, inv)
    return loss_sum * inv, tree_lib.unflatten(params, grads_sum)


def loss_and_grads(params: Any, cfg: ModelConfig, batch: Dict[str, Tensor],
                   microbatches: int = 1, aux_weight: float = 0.01,
                   grad_dtype: str = "float32") -> Tuple[Tensor, Any]:
    """Mean loss and gradients (a tree like ``params``). One microbatch:
    the gradients in the parameters' dtype; more: summed in ``grad_dtype``,
    then scaled by ``1/n``."""
    if microbatches <= 1:
        loss, grads = _value_and_grad(params, cfg, batch, aux_weight)
        return loss, tree_lib.unflatten(params, grads)

    acc_dtype = dtype_of(grad_dtype)
    loss_sum = acc = None
    for mb in _split_microbatches(batch, microbatches):
        loss, grads = _value_and_grad(params, cfg, mb, aux_weight)
        grads = [g.to(acc_dtype) for g in grads]
        if acc is None:
            loss_sum, acc = loss, grads  # 0 + g is g
        else:
            loss_sum = loss_sum + loss
            torch._foreach_add_(acc, grads)
        del loss, grads
    return mean_of(loss_sum, acc, params, microbatches)


def apply_update(state: TrainStateT, grads: Any, tcfg: TrainConfig
                 ) -> Tuple[TrainStateT, Dict[str, Tensor]]:
    """The AdamW update of ``state`` by ``grads``, in place, and the step
    counter advanced."""
    params, opt, metrics = opt_lib.apply(tcfg.optimizer, state.params, grads,
                                         state.opt)
    return TrainStateT(params, opt, state.step + 1), metrics


def train_step(state: TrainStateT, batch: Dict[str, Tensor],
               cfg: ModelConfig, tcfg: TrainConfig
               ) -> Tuple[TrainStateT, Dict[str, Tensor]]:
    """One optimizer update, in place. Returns ``(state, metrics)``:
    ``loss``, ``grad_norm``, ``lr`` and ``param_norm`` as 0-dim tensors (no
    device value is read back)."""
    loss, grads = loss_and_grads(
        state.params, cfg, batch, tcfg.microbatches, tcfg.aux_weight,
        grad_dtype=tcfg.optimizer.grad_dtype)
    state, metrics = apply_update(state, grads, tcfg)
    metrics["loss"] = loss
    return state, metrics
