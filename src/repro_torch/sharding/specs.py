"""Placement rules of the fleet, bank and gateway layouts (port of
``repro.sharding.specs``: ``fleet_specs`` through ``rebalance_placement``).

A :class:`PartitionSpec` says how an array sits on a one-axis
:class:`~repro_torch.sharding.mesh.Mesh`: ``P(axis)`` splits its leading
axis in contiguous equal blocks over the mesh axis, ``P()`` replicates it;
:func:`place` puts a tensor on the mesh by its spec. The model rules
(``SpecBuilder``, ``param_specs``, ``batch_specs``, ``decode_state_specs``)
come with the LM stack.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.mesh import Mesh, split

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """``axis`` None: replicated; else the leading axis split over it."""

    axis: Optional[str] = None


def P(axis: Optional[str] = None) -> PartitionSpec:
    return PartitionSpec(axis)


def place(x: Tensor, spec: PartitionSpec, mesh: Mesh) -> List[Tensor]:
    """``x`` on the mesh by ``spec``: one tensor per shard, on its device."""
    if spec.axis is None:
        return [x.to(dev) for dev in mesh.devices]
    if spec.axis != mesh.axis:
        raise KeyError(spec.axis)
    return split(x, mesh)


# ---------------------------------------------------------------------------
# Fleet-vectorized optimization
# ---------------------------------------------------------------------------


def fleet_specs(axis: str = "fleet") -> Tuple[PartitionSpec, PartitionSpec]:
    """Specs for fleet training against one replicated sketch
    (``core.distributed.fleet_fit``): every per-member array (iterates
    ``(F, d)``, sigma/lr ladders ``(F,)``, the draws' member axis, loss
    traces ``(F, steps)``) splits its fleet axis over ``axis``; the sketch,
    the hash family and scalars replicate. Counters are read-only during
    optimization, so the layout needs no per-step communication.

    Returns ``(fleet, replicated)``.
    """
    return P(axis), P()


def check_fleet_divisible(f: int, mesh: Mesh, axis: str) -> None:
    """Fail fast when the fleet cannot split evenly over the mesh axis."""
    size = mesh.shape[axis]
    if f % size:
        raise ValueError(
            f"fleet size {f} not divisible by mesh axis {axis!r} ({size} "
            f"devices); pad the fleet or choose F as a multiple"
        )


def bank_specs(axis: str = "bank") -> Tuple[PartitionSpec, PartitionSpec]:
    """Specs for banked fleet training (``core.distributed.fleet_fit_banked``):
    the ``(S, R, B)`` bank and its ``(S,)`` counts split their tenant axis
    over ``axis``, and every member-major ``(S*F, ...)`` array splits over
    the SAME axis, so each device holds its tenants' tables with exactly
    their fleet members. The hash family and scalars replicate; members
    never query another device's tenants, so there is no per-step
    communication.

    Returns ``(bank, replicated)``; ``bank`` serves the counter stack and
    the member-major arrays.
    """
    return P(axis), P()


def gateway_specs(axis: str = "bank") -> Tuple[PartitionSpec, PartitionSpec]:
    """Specs of the serving gateway's tick: :func:`bank_specs` applied to
    traffic. The bank, its counts and every per-tick buffer (the ``(S, I,
    dim)`` ingest stack and its mask, the tenant-major ``(S*Q, dim)`` query
    block and its mask) split their tenant axis over ``axis``: each device
    ingests and answers its own tenants with no per-tick communication.

    Returns ``(bank, replicated)``.
    """
    return bank_specs(axis)


def gateway_input_specs(axis: str = "bank") -> Tuple[PartitionSpec, ...]:
    """Per-tick buffer specs ``(zbuf, zmask, qbuf, qmask)`` of the gateway
    on a mesh: all four split their leading axis over ``axis`` (the query
    block in whole-tenant runs, as ``S`` divides the mesh axis), so each
    shard owns its block of the fused transfer and of the staging ring."""
    bank, _ = bank_specs(axis)
    return (bank, bank, bank, bank)


def check_bank_divisible(s: int, mesh: Mesh, axis: str) -> None:
    """Fail fast when the bank cannot split evenly over the mesh axis."""
    size = mesh.shape[axis]
    if s % size:
        raise ValueError(
            f"bank size {s} not divisible by mesh axis {axis!r} ({size} "
            f"devices); pad the bank or choose S as a multiple"
        )


def tenant_placement(tenants: int, mesh: Mesh, axis: str = "bank"
                     ) -> np.ndarray:
    """Tenant -> shard map of the ``P(axis)`` layout: slot ``i`` lives on
    shard ``i // (S / n_shards)``. The single owner of that arithmetic.

    Returns ``(tenants,)`` int32 shard indices.
    """
    check_bank_divisible(tenants, mesh, axis)
    shards = mesh.shape[axis]
    return np.repeat(np.arange(shards, dtype=np.int32), tenants // shards)


def rebalance_placement(loads, num_shards: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Load-balance tenants over equal-capacity shards, staying contiguous.

    Capacity-bounded LPT greedy: tenants in descending load order each go
    to the least-loaded shard that still has a free slot (each shard holds
    exactly ``T / num_shards`` tenants). The output is a slot PERMUTATION:
    placing tenant ``slot_tenant[i]`` at bank slot ``i`` makes the
    contiguous layout realize the balanced assignment.

    Args:
      loads: ``(T,)`` per-tenant load (any additive cost).
      num_shards: shard count; must divide ``T``.

    Returns:
      ``(slot_tenant, shard_of)``: ``slot_tenant[i]`` is the tenant to place
      at slot ``i`` (a permutation of ``arange(T)``), ``shard_of[t]`` tenant
      ``t``'s shard under that placement.
    """
    loads = np.asarray(loads, np.float64)
    t = loads.shape[0]
    if t % num_shards:
        raise ValueError(
            f"{t} tenants not divisible by {num_shards} shards; pad the "
            f"bank or choose T as a multiple"
        )
    cap = t // num_shards
    members: list = [[] for _ in range(num_shards)]
    totals = np.zeros(num_shards)
    for tenant in np.argsort(-loads, kind="stable"):
        open_shards = [s for s in range(num_shards) if len(members[s]) < cap]
        best = min(open_shards, key=lambda s: (totals[s], s))
        members[best].append(int(tenant))
        totals[best] += loads[tenant]
    slot_tenant = np.concatenate(
        [np.sort(np.asarray(m, np.int32)) for m in members])
    shard_of = np.empty((t,), np.int32)
    for shard, m in enumerate(members):
        shard_of[np.asarray(m, np.int32)] = shard
    return slot_tenant, shard_of
