"""Mixture-of-Experts layers: the SwiGLU FFN with GShard-style
capacity-based routing (port of ``repro.models.moe``), and the dropless
layer of NemotronH (:func:`dropless_moe`, the port's own; see there).

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

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
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


# ---------------------------------------------------------------------------
# The dropless layer (NemotronH's MoE; no counterpart in the reference)
# ---------------------------------------------------------------------------


def init_dropless(gen: torch.Generator, d: int, d_ff: int, num_experts: int,
                  shared_d_ff: int, dtype: torch.dtype) -> Params:
    """The router ``(d, E)`` and its score-correction bias ``(E,)`` (zero),
    the relu^2 experts' stacks ``up (E, d, d_ff)`` and ``down (E, d_ff,
    d)``, and with ``shared_d_ff`` the shared expert's ``shared_up (d,
    shared_d_ff)`` and ``shared_down``."""
    p = {
        "router": layers.normal((d, num_experts), d ** -0.5, dtype, gen),
        "router_bias": torch.zeros((num_experts,), dtype=dtype,
                                   device=gen.device),
        "up": layers.normal((num_experts, d, d_ff), d ** -0.5, dtype, gen),
        "down": layers.normal((num_experts, d_ff, d), d_ff ** -0.5, dtype,
                              gen),
    }
    if shared_d_ff:
        p["shared_up"] = layers.normal((d, shared_d_ff), d ** -0.5, dtype,
                                       gen)
        p["shared_down"] = layers.normal((shared_d_ff, d),
                                         shared_d_ff ** -0.5, dtype, gen)
    return p


def _relu2(x: Tensor) -> Tensor:
    return torch.square(F.relu(x))


# Routing records for a check: while a list is set here, each layer appends
# its chosen experts ``(T, k)``. Off, nothing is kept.
_choices: Optional[List[Tensor]] = None


@contextlib.contextmanager
def record_choices():
    """``with record_choices() as got:``: ``got`` receives each dropless
    layer's chosen experts ``(tokens, k)`` (int64, on the device) in call
    order. For checks that compare routings; the forward is unchanged."""
    global _choices
    prev, _choices = _choices, []
    try:
        yield _choices
    finally:
        _choices = prev


def route_sigmoid_bias(x: Tensor, router: Tensor, bias: Tensor, k: int,
                       scale: float) -> Tuple[Tensor, Tensor]:
    """NemotronH's router over ``x (T, d)``: scores ``s = sigmoid(x W)`` in
    f32; the top ``k`` of ``s + bias`` chosen; their weights ``s`` over
    their sum (+ 1e-20), times ``scale``. Returns ``(experts (T, k) int64,
    weights (T, k) f32)``."""
    scores = torch.sigmoid(x.to(torch.float32) @ router.to(torch.float32))
    idx = torch.topk(scores + bias.to(torch.float32), k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale
    return idx, w


def dropless_moe(params: Params, x: Tensor, *, experts_per_token: int,
                 routed_scale: float, compute_dtype: torch.dtype,
                 layer: int = 0, num_layers: int = 1) -> Tensor:
    """NemotronH's MoE of ``x (B, S, d)``, nothing dropped:
    ``sum_i w_i down_i(relu(up_i x)^2) + shared_down(relu(shared_up
    x)^2)`` over each token's ``k`` chosen experts
    (:func:`route_sigmoid_bias`).

    The ``T k`` (token, choice) rows are sorted by expert and gathered, and
    each of the two expert products is one grouped product over the routed
    rows alone (``torch._grouped_mm``, ``offs`` the experts' end rows): no
    capacity slots, no padding, and the rows per expert stay on the device,
    so the layer never waits for the host (on the card the grouped product
    takes bf16 alone: the model serves in bf16). The shared expert is a
    dense product. The combine puts the rows back in token order and sums them,
    weighted, in f32 with the shared expert's output, rounding once.

    Spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
    ``moe.combine`` and the counter ``moe.routed_rows`` while tracing is
    on; then also a tally of rows per (``layer``, expert) on the device
    (``tracing.tally("moe.expert_rows", ...)``, ``num_layers`` rows)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    k = experts_per_token
    t = b * s
    xc = x.to(compute_dtype).reshape(t, d)
    with tracing.span("moe.route"):
        idx, w = route_sigmoid_bias(xc, params["router"],
                                    params["router_bias"], k, routed_scale)
        if _choices is not None:
            _choices.append(idx)
    with tracing.span("moe.dispatch"):
        flat = idx.reshape(-1)                                  # (T k,)
        sorted_e, order = torch.sort(flat, stable=True)
        offs = torch.searchsorted(
            sorted_e, torch.arange(e, device=x.device), right=True)
        offs = offs.to(torch.int32)                             # end rows
        rows = xc[order // k]                                   # (T k, d)
    tracing.add("moe.routed_rows", t * k)
    if tracing.on():
        tracing.tally("moe.expert_rows", layer, num_layers,
                      torch.diff(offs, prepend=offs.new_zeros(1)))
    with tracing.span("moe.experts"):
        h = _relu2(torch._grouped_mm(rows, params["up"].to(compute_dtype),
                                     offs=offs))
        out = torch._grouped_mm(h, params["down"].to(compute_dtype),
                                offs=offs)                      # (T k, d)
        shared = None
        if "shared_up" in params:
            shared = _relu2(xc @ params["shared_up"].to(compute_dtype)) \
                @ params["shared_down"].to(compute_dtype)
    with tracing.span("moe.combine"):
        back = torch.empty_like(out)
        back[order] = out                                       # token order
        y = torch.einsum("tk,tkd->td", w, back.reshape(t, k, d).to(
            torch.float32))
        if shared is not None:
            y = y + shared.to(torch.float32)
    return y.to(compute_dtype).reshape(b, s, d)
