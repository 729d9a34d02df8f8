"""Mixture-of-Experts SwiGLU FFN with GShard-style capacity-based routing
(port of ``repro.models.moe``).

The routing is the reference's exactly: tokens in contiguous groups of at
most ``group_size``, ``capacity = max(1, int(g * k * cf / E))`` slots per
expert and group, ``k`` rounds of first-index ``argmax`` (each masks its
expert with ``-inf``), the chosen gates renormalized over the ``k``
choices, a token's slot the count of earlier tokens routed to that expert
(an integer cumsum) plus the slots earlier choices took, tokens past
capacity dropped, and the Switch auxiliary loss on the first choice.

The experts' products differ in form, not in value: where the reference
contracts ``(g, E, C)`` one-hot dispatch and combine tensors, the port
copies each kept (token, choice) into its expert's slot buffer, runs the
experts as batched products over ``(E, groups * C, d)``, and gathers each
token's ``k`` rows back, weighted by its combine value (rounded to the
compute dtype, as the reference's) and summed in f32 before one rounding.
Every slot a one-hot sum selects holds the same product, so the two agree
to the rounding of the expert products themselves; an empty slot computes
on zeros, as the reference's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_moe(gen: torch.Generator, d: int, d_ff: int, num_experts: int,
             dtype: torch.dtype) -> Params:
    """The router ``(d, E)`` and the expert stacks ``(E, d, d_ff)`` /
    ``(E, d_ff, d)``, drawn from ``gen``."""
    s_in, s_ff = d ** -0.5, d_ff ** -0.5
    return {
        "router": layers.normal((d, num_experts), s_in, dtype, gen),
        "gate": layers.normal((num_experts, d, d_ff), s_in, dtype, gen),
        "up": layers.normal((num_experts, d, d_ff), s_in, dtype, gen),
        "down": layers.normal((num_experts, d_ff, d), s_ff, dtype, gen),
    }


class Routing(NamedTuple):
    """Where each (choice, group, token) goes: ``expert``, ``slot`` (int64)
    and the renormalized ``gate`` (f32), each ``(k, G, g)``; ``kept`` is
    False where the slot is past capacity."""

    expert: Tensor
    slot: Tensor
    gate: Tensor
    kept: Tensor


def _top_k_dispatch(logits: Tensor, k: int, capacity: int
                    ) -> Tuple[Routing, Tensor]:
    """Route ``logits (G, g, E)`` (f32) to ``k`` experts a token. Returns
    the routing and the scalar Switch loss ``E * <f, p>`` (``f`` the share
    of tokens whose first choice is each expert, ``p`` the mean router
    probability)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    masked = logits
    experts, gates = [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                      # (G, g)
        experts.append(idx)
        gates.append(torch.gather(probs, -1, idx[..., None])[..., 0])
        masked = masked.scatter(-1, idx[..., None], float("-inf"))
    gate = torch.stack(gates)                                   # (k, G, g)
    gate = gate / torch.clamp(gate.sum(dim=0, keepdim=True), min=1e-9)
    taken = torch.zeros((logits.shape[0], e), dtype=torch.int64,
                        device=logits.device)
    slots = []
    for idx in experts:
        mask = F.one_hot(idx, e)                                # (G, g, E)
        # The slot: earlier tokens of this group routed to the expert by
        # this choice, plus what earlier choices took.
        pos = torch.cumsum(mask, dim=1) - mask + taken[:, None, :]
        slots.append(torch.gather(pos, -1, idx[..., None])[..., 0])
        taken = taken + mask.sum(dim=1)
    slot = torch.stack(slots)
    first = F.one_hot(experts[0], e).to(torch.float32)
    aux = e * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    return Routing(expert=torch.stack(experts), slot=slot, gate=gate,
                   kept=slot < capacity), aux


def moe_ffn(params: Params, x: Tensor, *, experts_per_token: int,
            capacity_factor: float, compute_dtype: torch.dtype,
            group_size: int = 4096) -> Tuple[Tensor, Tensor]:
    """MoE SwiGLU FFN of ``x (B, S, d)``. Returns ``(out (B, S, d), aux)``.

    Capacity is per group of ``min(group_size, S)`` tokens (``S`` must be a
    multiple of it). Decode calls it on ``(B, 1, d)``: one group a lane,
    capacity 1, and no token is dropped."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    k = experts_per_token
    xc = x.to(compute_dtype)
    g = min(group_size, s)
    if s % g:
        raise ValueError(f"sequence {s} is not a multiple of the group {g}")
    groups = b * (s // g)
    xg = xc.reshape(groups, g, d)
    logits = (xg @ params["router"].to(compute_dtype)).to(torch.float32)
    capacity = max(1, int(g * k * capacity_factor / e))
    routing, aux = _top_k_dispatch(logits, k, capacity)

    # Each kept (choice, group, token) -> its row in the experts' slot
    # buffers, (E, groups * C) flattened; a dropped one -> a spare zero row
    # past the end.
    cells = e * groups * capacity
    group_ids = torch.arange(groups, device=x.device)[None, :, None]
    row = (routing.expert * groups + group_ids) * capacity + routing.slot
    row = torch.where(routing.kept, row, cells)                 # (k, G, g)
    tokens = xg[None].expand(k, groups, g, d).reshape(-1, d)
    xin = torch.zeros((cells + 1, d), dtype=compute_dtype, device=x.device)
    xin.index_copy_(0, row.reshape(-1), tokens)
    xin = xin[:cells].reshape(e, groups * capacity, d)
    gate = F.silu(torch.bmm(xin, params["gate"].to(compute_dtype)))
    up = torch.bmm(xin, params["up"].to(compute_dtype))
    out_e = torch.bmm(gate * up, params["down"].to(compute_dtype))
    out_e = torch.cat([out_e.reshape(cells, d),
                       out_e.new_zeros((1, d))])
    # Combine: each token's k expert rows, weighted by its gate in the
    # compute dtype, summed in f32 and rounded once.
    weight = torch.where(routing.kept, routing.gate, 0.0).to(compute_dtype)
    picked = out_e[row.reshape(-1)].reshape(k, groups, g, d)
    out = (picked.to(torch.float32)
           * weight.to(torch.float32)[..., None]).sum(dim=0)
    return out.to(compute_dtype).reshape(b, s, d), aux
