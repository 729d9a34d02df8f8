"""AdamW with a dtype policy and a warmup-cosine schedule (port of
``repro.train.optimizer``).

The update is the reference's, not ``torch.optim.AdamW``'s: the schedule and
the bias corrections read ``step + 1``; gradients are clipped by
``min(1, clip / (gnorm + 1e-9))`` on a global norm summed in f32; ``eps``
sits outside ``sqrt(nu_hat)``; weight decay, on every leaf (norms and the
embedding too), is added to the Adam direction before the learning rate
scales it. When some parameter's dtype differs from ``master_dtype`` the
state holds master copies (f32 by default), the update runs on them and the
parameters are their casts; moments may be stored in bf16, the update
itself is f32.

The port updates the state and the parameters in place, under
``torch.no_grad()``, and returns the same trees: at 1e9 parameters a
functional update would hold a second copy of everything. Leaves are
updated with ``torch._foreach_*`` ops over groups of at most
``_GROUP_ELEMENTS`` elements, which bounds the f32 temporaries. The step
counter lives on the host (an int32 tensor on the CPU): the learning rate
and the bias corrections are computed there in f32, as the reference
computes them, and the update reads no device value back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.train import tree as tree_lib

Tensor = torch.Tensor

# f32 temporaries of one group: about 3 x 4 bytes an element.
_GROUP_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # bf16 halves optimizer memory
    master_dtype: str = "float32"        # f32 master copies when params bf16;
                                         # equal to the param dtype: none
    grad_dtype: str = "float32"          # accumulation dtype for microbatches
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor     # int32, on the host
    mu: Any          # first moment, tree like params
    nu: Any          # second moment
    master: Any      # master weights (None when params are already f32)


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, in f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cosine
    return cfg.learning_rate * warm * decay


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each parameter; master copies
    when some parameter is not in ``master_dtype``."""
    mdt = dtype_of(cfg.moment_dtype)
    master_dt = dtype_of(cfg.master_dtype)
    with torch.no_grad():
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        needs_master = any(p.dtype != master_dt
                           for p in tree_lib.leaves(params))
        master = (tree_lib.tree_map(
            lambda p: p.detach().to(master_dt, copy=True), params)
            if needs_master else None)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_lib.tree_map(zeros, params),
                          nu=tree_lib.tree_map(zeros, params),
                          master=master)


def global_norm(tree: Any) -> Tensor:
    """``sqrt`` of the sum of every leaf's squares, each summed in f32."""
    norms = torch._foreach_norm(tree_lib.leaves(tree), 2,
                                dtype=torch.float32)
    return torch.sqrt(torch.stack(norms).square().sum())


def _groups(tensors: List[Tensor]) -> List[List[int]]:
    """Consecutive leaf indices, at most ``_GROUP_ELEMENTS`` elements a
    group (a larger leaf alone)."""
    groups, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and size + t.numel() > _GROUP_ELEMENTS:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    if cur:
        groups.append(cur)
    return groups


def _f32(ts: List[Tensor]) -> List[Tensor]:
    """f32 tensors, the same ones where they are f32 already."""
    return [t if t.dtype == torch.float32 else t.to(torch.float32)
            for t in ts]


def _store(dst: List[Tensor], src: List[Tensor]) -> None:
    """Copy each f32 result into its store unless it is the store."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState
          ) -> Tuple[Any, AdamWState, Dict[str, Tensor]]:
    """One AdamW update, in place. Returns ``(params, state, metrics)``:
    the same trees, updated, and ``grad_norm``, ``lr``, ``param_norm``."""
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr_, b1c_, b2c_ = float(lr), float(b1c), float(b2c)  # exact f32 values

    p_leaves = tree_lib.leaves(params)
    g_leaves = tree_lib.leaves(grads)
    mu_leaves = tree_lib.leaves(state.mu)
    nu_leaves = tree_lib.leaves(state.nu)
    src_leaves = (tree_lib.leaves(state.master) if state.master is not None
                  else p_leaves)
    gnorm = global_norm(g_leaves)
    clip_scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    for idx in _groups(p_leaves):
        pick = lambda ts: [ts[i] for i in idx]
        g = torch._foreach_mul(_f32(pick(g_leaves)), clip_scale)
        mu = _f32(pick(mu_leaves))
        nu = _f32(pick(nu_leaves))
        # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g g
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(nu, cfg.b2)
        g2 = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_add_(nu, g2)
        del g, g2
        # delta = mu_hat / (sqrt(nu_hat) + eps) + wd p; p -= lr delta
        denom = torch._foreach_div(nu, b2c_)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(mu, b1c_)
        torch._foreach_div_(delta, denom)
        del denom
        p32 = _f32(pick(src_leaves))
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_sub_(p32, torch._foreach_mul(delta, lr_))
        del delta
        _store(pick(mu_leaves), mu)
        _store(pick(nu_leaves), nu)
        _store(pick(src_leaves), p32)
        if state.master is not None:
            _store(pick(p_leaves), p32)
    metrics = {"grad_norm": gnorm, "lr": lr,
               "param_norm": global_norm(p_leaves)}
    return params, AdamWState(step, state.mu, state.nu, state.master), metrics
