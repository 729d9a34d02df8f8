"""Placement rules and placement (port of ``repro.sharding.specs``).

A :class:`PartitionSpec` says how an array sits on a
:class:`~repro_torch.sharding.mesh.Mesh`: one entry per leading dimension,
each ``None`` (the dimension is whole on every device), an axis name or a
tuple of names (major to minor: the dimension is cut into the product of
those axes' sizes, and a device takes the block at the linear index of its
coordinates over them); ``P("bank")`` splits the leading axis over
``bank``, ``P()`` replicates. :func:`place` cuts a tensor into one block per
device by its spec, :func:`device_put` puts a tree on the mesh as
:class:`ShardedTensor` leaves (the counterpart of ``jax.device_put`` with a
``NamedSharding``: each block a copy of its own), and :func:`gather_tree`
rebuilds every leaf on the mesh's first device, bit for bit.

Two halves of rules: the fleet, bank and gateway layouts (the STORM side),
and the LM's (``SpecBuilder``, :func:`param_specs`, :func:`opt_state_specs`,
:func:`batch_specs`, :func:`decode_state_specs`,
:func:`activation_hint_rules`). The LM rules read only leaves' shapes, so
they take shape-only trees (:func:`eval_shape`: meta tensors) and a mesh of
any size, the production 16 x 16 named on one device included.

The port's ``blocks`` and decode states are lists of cycles whose leaves
lack the reference's leading ``num_cycles`` axis. A leaf under a cycle is
given the spec the reference's rules give its stacked shape ``(num_cycles,)
+ shape``, without that leading entry: its rank, and the size the FSDP
threshold reads, are the stacked array's (a KV cache is rank 5 there, an
mLSTM state rank 5 or 4).

The single controller keeps the model whole: rules and placement decide
where leaves live (placement, restore onto a mesh, memory per device); the
model computes on one device from gathered leaves. GSPMD's partitioning of
the computation has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.mesh import Mesh
from repro_torch.train import tree as tree_lib

Tensor = torch.Tensor
Entry = Union[None, str, Tuple[str, ...]]

FSDP_MIN_SIZE = 1 << 20  # don't bother FSDP-sharding params under 1M elements


class PartitionSpec:
    """One entry per leading dimension: ``None``, an axis name or a tuple of
    names (major first); as ``jax.sharding.PartitionSpec`` does, a tuple of
    one name is stored as the name and an empty one as ``None``. Iterates,
    indexes and compares (with another spec) as its tuple of entries;
    unlike JAX's it is no tuple, so trees of specs keep it as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        norm = []
        for e in entries:
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                if not all(isinstance(a, str) for a in e):
                    raise TypeError(f"a spec entry's tuple holds names; got "
                                    f"{e!r}")
                e = None if not e else e[0] if len(e) == 1 else e
            elif not (e is None or isinstance(e, str)):
                raise TypeError(f"a spec entry is None, a name or a tuple "
                                f"of names; got {e!r}")
            norm.append(e)
        self.entries = tuple(norm)

    @property
    def axis(self) -> Optional[str]:
        """The leading entry when it is one name (``P(axis)``), else None."""
        lead = self.entries[0] if self.entries else None
        return lead if isinstance(lead, str) else None

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The names dimension ``dim`` is cut over (``()``: whole)."""
        e = self.entries[dim] if dim < len(self.entries) else None
        return () if e is None else (e,) if isinstance(e, str) else e

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, PartitionSpec)
                and self.entries == other.entries)

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def P(*entries: Entry) -> PartitionSpec:
    return PartitionSpec(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    def indices(self, shape) -> List[Tuple[slice, ...]]:
        """Device ``i``'s block of an array of ``shape``, as slices, for
        every device of the mesh in order (``devices_indices_map``). Raises
        on an axis the mesh lacks, an axis named twice, more entries than
        dimensions, or a dimension its axes do not divide."""
        shape = tuple(shape)
        mesh, spec = self.mesh, self.spec
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than the array "
                             f"of shape {shape} has dimensions")
        named = [a for d in range(len(spec)) for a in spec.axes(d)]
        for a in named:
            if a not in mesh.axis_names:
                raise KeyError(a)
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} names an axis twice")
        cuts = []
        for d, n in enumerate(shape):
            axes = spec.axes(d)
            parts = math.prod(mesh.shape[a] for a in axes)
            if n % parts:
                raise ValueError(
                    f"dimension {d} of size {n} not divisible by mesh axes "
                    f"{axes} ({parts} blocks)")
            cuts.append((axes, n // parts))
        out = []
        for i in range(mesh.size):
            coords = mesh.coords(i)
            idx = []
            for axes, size in cuts:
                b = 0
                for a in axes:
                    b = b * mesh.shape[a] + coords[a]
                idx.append(slice(b * size, (b + 1) * size))
            out.append(tuple(idx))
        return out


def place(x: Tensor, spec: PartitionSpec, mesh: Mesh) -> List[Tensor]:
    """``x`` on the mesh by ``spec``: block ``i`` on device ``i``, a view
    where it already lives there (``x`` itself where the spec cuts
    nothing)."""
    idx = NamedSharding(mesh, spec).indices(x.shape)
    return [(x if all(s == slice(0, n) for s, n in zip(ix, x.shape))
             else x[ix]).to(dev) for ix, dev in zip(idx, mesh.devices)]


class ShardedTensor:
    """An array placed on a mesh: one block per device, in the mesh's order
    (``jax.Array``'s ``addressable_shards``). Each block is its own copy on
    its device, as on separate cards, even where a device repeats."""

    def __init__(self, x: Tensor, sharding: NamedSharding):
        self.sharding = sharding
        self.shape = tuple(x.shape)
        self.dtype = x.dtype
        self.blocks = tuple(
            torch.empty(blk.shape, dtype=x.dtype, device=dev).copy_(blk)
            for blk, dev in zip(place(x.detach(), sharding.spec,
                                      sharding.mesh),
                                sharding.mesh.devices))

    def block_bytes(self) -> List[int]:
        """The bytes each device holds."""
        return [b.numel() * b.element_size() for b in self.blocks]

    def gather(self) -> Tensor:
        """The whole array on the mesh's first device, bit for bit."""
        mesh = self.sharding.mesh
        out = torch.empty(self.shape, dtype=self.dtype, device=mesh.first)
        for ix, blk in zip(self.sharding.indices(self.shape), self.blocks):
            out[ix] = blk.to(mesh.first)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec})")


def named(mesh: Mesh, specs: Any) -> Any:
    """A :class:`NamedSharding` for every spec of a tree."""
    return tree_lib.tree_map(lambda s: NamedSharding(mesh, s), specs)


def _by_path(shardings: Any) -> Dict[str, NamedSharding]:
    return dict(tree_lib.leaf_paths(shardings))


def device_put(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` placed by its sharding (a tree of
    :class:`NamedSharding` with ``tree``'s structure, or one for all
    leaves) as a :class:`ShardedTensor`."""
    if isinstance(shardings, NamedSharding):
        return tree_lib.tree_map(lambda x: ShardedTensor(x, shardings), tree)
    table = _by_path(shardings)
    return tree_lib.map_with_path(
        lambda path, x: ShardedTensor(x, table[path]), tree)


def gather_tree(tree: Any) -> Any:
    """Every :class:`ShardedTensor` of ``tree`` whole on its mesh's first
    device."""
    return tree_lib.tree_map(
        lambda x: x.gather() if isinstance(x, ShardedTensor) else x, tree)


def shard_bytes(tree: Any) -> List[int]:
    """The bytes each device of the (one) mesh holds of a placed tree."""
    per = [x.block_bytes() for x in tree_lib.leaves(tree)]
    return [sum(col) for col in zip(*per)]


def spec_bytes(tree: Any, spec_tree: Any, mesh: Mesh) -> int:
    """The bytes one device holds of ``tree`` (tensors or meta tensors)
    placed by ``spec_tree`` on ``mesh``, counted from the specs: each leaf's
    bytes over the product of the sizes of the axes its spec names (the
    same on every device: the rules cut evenly or raise)."""
    table = _by_path(spec_tree)
    total = 0
    for path, x in tree_lib.leaf_paths(tree):
        spec = table[path]
        parts = math.prod(mesh.shape[a] for d in range(len(spec))
                          for a in spec.axes(d))
        total += x.numel() * x.element_size() // parts
    return total


def eval_shape(fn: Callable, *args, **kwargs) -> Any:
    """``fn(*args, **kwargs)``'s tree of tensors as meta tensors of the same
    shapes and dtypes, with nothing allocated (``jax.eval_shape``): ``fn``
    runs under a fake-tensor mode, so it may name the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return tree_lib.tree_map(
        lambda t: (torch.empty(t.shape, dtype=t.dtype, device="meta")
                   if isinstance(t, torch.Tensor) else t), out)


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


# ---------------------------------------------------------------------------
# The LM: parameters, optimizer state, inputs, decode states, activations
# ---------------------------------------------------------------------------


def mesh_axes(mesh: Mesh) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(fsdp_axes, tp_axis)``: ``(pod, data)`` where present, ``model``
    or None."""
    names = mesh.axis_names
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return fsdp, tp


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


class SpecBuilder:
    """The reference's rule kit: TP over ``model`` (Megatron column then
    row) where a dimension divides it, FSDP over ``(pod, data)`` on another
    dimension of a leaf of at least ``FSDP_MIN_SIZE`` elements, experts over
    ``model`` when their count divides it. Shapes here are the reference's
    (stacked under ``blocks``)."""

    def __init__(self, mesh: Mesh, cfg: ModelConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp, self.tp = mesh_axes(mesh)
        self.tp_size = _axis_size(mesh, self.tp)
        self.fsdp_size = _axis_size(mesh, self.fsdp)

    def _tp_if(self, dim: int) -> Optional[str]:
        return self.tp if self.tp and dim % self.tp_size == 0 else None

    def _fsdp_if(self, dim: int, numel: int):
        if not self.fsdp or numel < FSDP_MIN_SIZE:
            return None
        return self.fsdp if dim % self.fsdp_size == 0 else None

    def matmul2d(self, shape, stacked: bool, tp_dim: int) -> PartitionSpec:
        """A (stacked) 2D weight: TP on logical dim ``tp_dim`` (0 or 1),
        FSDP on the other where it divides."""
        off = 1 if stacked else 0
        dims = [shape[off], shape[off + 1]]
        numel = math.prod(shape)
        spec = [None] * len(shape)
        tp_axis = self._tp_if(dims[tp_dim])
        if tp_axis:
            spec[off + tp_dim] = tp_axis
        other = 1 - tp_dim
        spec[off + other] = self._fsdp_if(dims[other], numel)
        return P(*spec)

    def replicated_fsdp(self, shape, stacked: bool,
                        dim: int = 0) -> PartitionSpec:
        """No TP; FSDP on one dim if large enough."""
        off = 1 if stacked else 0
        spec = [None] * len(shape)
        spec[off + dim] = self._fsdp_if(shape[off + dim], math.prod(shape))
        return P(*spec)

    def moe3d(self, shape, stacked: bool,
              tp_dim_in_expert: int) -> PartitionSpec:
        """``(L?, E, d0, d1)``: experts over TP when divisible (expert
        parallelism, FSDP on d0), else TP inside each expert."""
        off = 1 if stacked else 0
        e = shape[off]
        numel = math.prod(shape)
        spec = [None] * len(shape)
        if self.tp and e % self.tp_size == 0:
            spec[off] = self.tp
            spec[off + 1] = self._fsdp_if(shape[off + 1], numel)
        else:
            spec[off + 1 + tp_dim_in_expert] = self._tp_if(
                shape[off + 1 + tp_dim_in_expert])
            other = 1 - tp_dim_in_expert
            spec[off + 1 + other] = self._fsdp_if(shape[off + 1 + other],
                                                  numel)
        return P(*spec)


def _stacked_rule(rule: Callable[[Tuple[int, ...]], PartitionSpec],
                  shape, cycles: int) -> PartitionSpec:
    """A cycle leaf's spec: ``rule`` over the stacked shape, without the
    stack's entry."""
    return P(*rule((cycles,) + tuple(shape)).entries[1:])


def _param_rule(path: str, shape: Tuple[int, ...], stacked: bool,
                sb: SpecBuilder) -> PartitionSpec:
    """The reference's ``param_spec`` over a (stacked) shape."""
    ndim = len(shape)
    name = path.split("'")[-2]  # the last quoted key

    if ndim - (1 if stacked else 0) <= 1:
        # norms, biases, gate scalars: replicate (except wide out_norms)
        if name == "out_norm" and shape[-1] % sb.tp_size == 0 \
                and sb.tp:
            return P(*([None] * (ndim - 1) + [sb.tp]))
        return P(*([None] * ndim))
    numel = math.prod(shape)
    if name == "embed":
        return P(sb._tp_if(shape[0]), sb._fsdp_if(shape[1], numel))
    if name == "unembed":
        return P(sb._fsdp_if(shape[0], numel), sb._tp_if(shape[1]))

    if "['moe']" in path:
        if name == "router":
            return sb.replicated_fsdp(shape, stacked, dim=0)
        if name in ("gate", "up"):
            return sb.moe3d(shape, stacked, tp_dim_in_expert=1)
        if name == "down":
            return sb.moe3d(shape, stacked, tp_dim_in_expert=0)

    if name in ("wq", "wk", "wv"):
        # column-parallel; K/V replicate when kv-heads don't divide TP
        if name in ("wk", "wv"):
            kv = sb.cfg.num_kv_heads
            if sb.tp and kv % sb.tp_size != 0:
                return sb.replicated_fsdp(shape, stacked, dim=0)
        return sb.matmul2d(shape, stacked, tp_dim=1)
    if name in ("wo", "down", "wd"):
        return sb.matmul2d(shape, stacked, tp_dim=0)
    if name in ("gate", "up", "wo_gate", "w_x", "w_z"):
        return sb.matmul2d(shape, stacked, tp_dim=1)
    if name in ("w_bc", "w_dt", "w_if", "router"):
        return sb.replicated_fsdp(shape, stacked, dim=0)
    if name in ("conv_x_w", "conv_bc_w"):
        off = 1 if stacked else 0
        spec = [None] * ndim
        spec[off + 1] = (sb._tp_if(shape[off + 1])
                         if name == "conv_x_w" else None)
        return P(*spec)
    # default: replicate small, FSDP large
    return sb.replicated_fsdp(shape, stacked, dim=0)


def param_spec(path: str, leaf, sb: SpecBuilder) -> PartitionSpec:
    """A parameter's spec from its path (``tree.leaf_paths`` names: the
    leaf's name is the last quoted key) and its shape. A leaf under
    ``blocks`` takes the spec of its ``(num_cycles,) + shape`` stack."""
    if path.startswith("['blocks']"):
        return _stacked_rule(
            lambda shape: _param_rule(path, shape, True, sb),
            leaf.shape, sb.cfg.num_cycles)
    return _param_rule(path, tuple(leaf.shape), False, sb)


def param_specs(params: Any, cfg: ModelConfig, mesh: Mesh) -> Any:
    """A spec for every parameter (the tree's structure)."""
    b = SpecBuilder(mesh, cfg)
    return tree_lib.map_with_path(lambda path, leaf: param_spec(path, leaf, b),
                                  params)


def opt_state_specs(opt_state: Any, pspecs: Any) -> Any:
    """AdamW's specs: the moments and master copies mirror the parameters'
    (ZeRO-1 for free), the step counter replicates; ``master`` may be
    ``None``."""
    from repro_torch.train.optimizer import AdamWState

    table = _by_path(pspecs)

    def like_params(subtree):
        return tree_lib.map_with_path(lambda path, _: table[path], subtree)

    return AdamWState(
        step=P(),
        mu=like_params(opt_state.mu),
        nu=like_params(opt_state.nu),
        master=(None if opt_state.master is None
                else like_params(opt_state.master)))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_specs(batch: Any, mesh: Mesh) -> Any:
    """Token, label and embeds batches: dim 0 (batch) over the DP axes
    where it divides."""
    dp = dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)

    def spec(leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.shape[0] % max(dp_size, 1) == 0 and dp:
            return P(dp, *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return tree_lib.tree_map(spec, batch)


def decode_state_specs(state: Any, cfg: ModelConfig, mesh: Mesh,
                       batch_size: int) -> Any:
    """Decode-state specs (the port's list of cycles). The reference's
    rules, on each leaf's stacked shape ``(cycles, B, ...)``:

    * rank 5 (KV caches ``(cycles, B, KH, T, hd)``; an mLSTM ``s`` too): B
      over DP when divisible; dim 2 over TP when divisible, else dim 3 (the
      sequence, flash-decoding); at a batch DP does not divide, dim 3 also
      takes the DP axes.
    * rank 3-4 (recurrent states ``(cycles, B, H, ...)``): B over DP; dim
      2 over TP when divisible, else dim 3.
    """
    b = SpecBuilder(mesh, cfg)
    dp = dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    batch_ok = dp and batch_size % dp_size == 0

    def rule(shape):
        ndim = len(shape)
        spec_l = [None] * ndim
        if ndim >= 2 and batch_ok:
            spec_l[1] = dp
        if ndim == 5:
            kh, t = shape[2], shape[3]
            if b.tp and kh % b.tp_size == 0:
                spec_l[2] = b.tp
            elif b.tp and t % b.tp_size == 0:
                spec_l[3] = b.tp
            if not batch_ok and dp and t % (dp_size * b.tp_size) == 0 and \
                    spec_l[3] == b.tp:
                spec_l[3] = tuple(dp) + (b.tp,)
            elif not batch_ok and dp and spec_l[3] is None and \
                    t % dp_size == 0:
                spec_l[3] = dp
        elif ndim >= 3:
            h = shape[2]
            if b.tp and h % b.tp_size == 0:
                spec_l[2] = b.tp
            elif b.tp and ndim >= 4 and shape[3] % b.tp_size == 0:
                spec_l[3] = b.tp
        return P(*spec_l)

    return tree_lib.tree_map(
        lambda leaf: _stacked_rule(rule, leaf.shape, cfg.num_cycles), state)


def activation_hint_rules(cfg: ModelConfig, mesh: Mesh
                          ) -> Dict[str, PartitionSpec]:
    """Named rules for ``sharding.constraints.hint`` inside the model."""
    dp = dp_axes(mesh)
    if cfg.sequence_parallel and "model" in mesh.axis_names:
        # linear-recurrence archs: activations sequence-sharded over `model`
        return {"residual": P(dp, "model", None)}
    return {"residual": P(dp, None, None)}
