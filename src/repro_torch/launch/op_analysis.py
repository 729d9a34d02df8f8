"""Op-by-op roofline accounting of an eager program (port of
``repro.launch.hlo_analysis``).

The reference re-derives the roofline inputs from the compiled, per-device
HLO: every post-optimization fusion is a kernel launch, every ``dot`` is
``2 * prod(out) * K`` FLOPs, ``while`` bodies count once per trip. The port
runs eagerly, so its counterpart of a fusion is an aten op: the eager port
launches about one kernel per op. :class:`OpCounter` is a
``TorchDispatchMode`` that sees every op a program dispatches, the
backward's and remat's recompute included, and counts:

  * ``flops``: the products' FLOPs by ``torch.utils.flop_counter``'s
    registered formulas (mm, bmm, addmm, baddbmm, convolution, the SDPA
    ops: what ``FlopCounterMode`` counts), split by the products' input
    dtype as ``flops:bf16``, ``flops:f32`` (and ``flops:<dtype>`` for any
    other);
  * ``hbm_bytes``: for every op but views and aliases (the counterpart of
    ``_FREE_OPS``), its tensor inputs' bytes plus its outputs' bytes;
  * ``min_bytes``: each byte of the program's inputs read once and each
    byte its outputs must change written once, whatever implements it (the
    roofline's byte count). An output that is an input updated counts only
    the bytes the program writes into it: an input returned unchanged
    writes nothing, one updated in place writes what the in-place ops
    write (at most its size), and a copy of an input with a region
    replaced (``index_copy``, ``scatter``: a decode step's new cache
    slots) writes the region. Any other output is written whole;
  * ``peak_bytes``: the largest sum of the storages the program created
    that were alive at once (added when an op creates a storage, taken off
    when the storage is freed; views share their base's storage);
  * ``launches``: the ops counted;
  * ``collective_bytes`` and ``coll:<kind>``: the transfers the mesh code
    reports (:func:`repro_torch.sharding.mesh.note_transfer`: ``psum``,
    ``gather``, the pipeline's hand-overs). The single controller runs every
    shard from one process, so these are copies between the mesh's devices;
    the port has no GSPMD to trace.

The counts read only shapes, dtypes and the ops dispatched, so a program
counts the same on fake tensors (``FakeTensorMode``: nothing allocated) as
on real CPU or CUDA tensors of the same shapes. Every number is the whole
program's: divide by the devices of a mesh for the per-device form (the
reference's ``roofline.py:6-8``).
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.sharding import mesh as mesh_lib

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# Ops that move no data (views, aliases, storage without a write, host
# scalars): no bytes, no launch. Every op whose schema returns an alias of
# an input is free as well (``OpOverload.is_view``).
_FREE_OPS = frozenset({
    aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_strided,
    aten.empty_like, aten._local_scalar_dense,
})
# A metadata query, not an op of the program: meta and fake tensors ask it
# of the mode.
_QUERY = torch.ops.prim.device

# Ops that return their first argument with a region replaced (or replace it
# in place): the bytes of the region.
_REGION = {
    aten.index_copy: lambda a, out: _nbytes(a[3]),
    aten.index_copy_: lambda a, out: _nbytes(a[3]),
    aten.scatter: lambda a, out: a[2].numel() * out.element_size(),
}

_DTYPE_KEYS = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64"}


def _flop_registry() -> Dict[Any, Callable]:
    from torch.utils.flop_counter import flop_registry

    return dict(flop_registry)


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a program's arguments or results (any pytree)."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _written_args(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place (its schema's ``Tensor(a!)``)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            out += _tensors(args[i] if i < len(args)
                            else kwargs.get(arg.name))
    return out


def _product_dtype(args) -> str:
    """The dtype key of a product: its first floating input of rank >= 2
    (``addmm``'s bias and ``baddbmm``'s input come first)."""
    for t in _tensors(args):
        if t.dtype.is_floating_point and t.dim() >= 2:
            return _DTYPE_KEYS.get(t.dtype, str(t.dtype).split(".")[-1])
    return "f32"


class OpCounter(TorchDispatchMode):
    """Counts what the enclosed eager code does, op by op (see the module
    docstring). Enter it with ``with``; :attr:`counts` holds the totals.
    Stack it above a ``FakeTensorMode`` to count without allocating.

    ``trips`` multiplies what the ops run meanwhile add (not the peak): set
    it around one run of a loop's body to count the whole loop, as the
    reference multiplies a ``while`` body by its trip count.

    ``inputs`` are the program's inputs, for :meth:`min_bytes`."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        self._inputs = _leaves(inputs)
        self._input_keys = {_storage_key(t) for t in self._inputs}
        self.counts: Dict[str, float] = {
            "flops": 0.0, "flops:bf16": 0.0, "flops:f32": 0.0,
            "hbm_bytes": 0.0, "min_bytes": 0.0, "peak_bytes": 0.0,
            "launches": 0.0, "collective_bytes": 0.0,
            **{f"coll:{kind}": 0.0 for kind in COLLECTIVES},
        }
        self._flops = _flop_registry()
        # re-entrant: a weakref callback may fire on this thread while it
        # holds the lock (a collection run inside the tracking)
        self._lock = threading.RLock()
        self._live: Dict[int, int] = {}      # storage key -> bytes
        self._refs: Dict[int, weakref.ref] = {}
        self._live_bytes = 0
        # storage key -> bytes written into it in place; storage key of a
        # region-replaced copy -> (its source's key, the region's bytes)
        self._written: Dict[int, int] = {}
        self._copied_from: Dict[int, Tuple[int, int]] = {}
        self.trips = 1

    # -- storages ------------------------------------------------------------

    def _freed(self, key: int, _ref) -> None:
        with self._lock:
            self._refs.pop(key, None)
            self._written.pop(key, None)
            self._copied_from.pop(key, None)
            self._live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, inputs) -> None:
        seen = {_storage_key(t) for t in inputs}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            with self._lock:
                self._live[key] = st.nbytes()
                self._live_bytes += st.nbytes()
                self._refs[key] = weakref.ref(
                    st, lambda r, key=key: self._freed(key, r))
                if self._live_bytes > self.counts["peak_bytes"]:
                    self.counts["peak_bytes"] = float(self._live_bytes)

    def _note_writes(self, func, packet, args, kwargs, out) -> None:
        """Record what :meth:`min_bytes` needs of this op's writes."""
        region = _REGION.get(packet)
        written = _written_args(func, args, kwargs)
        with self._lock:
            for t in written:
                key = _storage_key(t)
                if key in self._input_keys or key in self._live:
                    n = region(args, t) if region else _nbytes(t)
                    self._written[key] = self._written.get(key, 0) + n
            if (not written and region is not None
                    and isinstance(out, torch.Tensor)):
                self._copied_from[_storage_key(out)] = (
                    _storage_key(args[0]), region(args, out))

    def _bytes_written(self, t: torch.Tensor) -> int:
        """The least bytes the program writes to produce output ``t``."""
        key, total = _storage_key(t), 0
        while True:
            total += self._written.get(key, 0)
            if key in self._input_keys:
                return min(total, _nbytes(t))
            if key not in self._copied_from:
                return _nbytes(t)
            key, region = self._copied_from[key]
            total += region

    def min_bytes(self, outputs: Any) -> int:
        """Each distinct input tensor read once, and each distinct tensor of
        ``outputs`` written where the program changed it (see the module
        docstring)."""
        total = 0
        for tree, size in ((self._inputs, _nbytes),
                           (outputs, self._bytes_written)):
            seen = set()
            for t in _leaves(tree):
                if id(t) not in seen:
                    seen.add(id(t))
                    total += size(t)
        return total

    # -- collectives -----------------------------------------------------------

    def _transfer(self, kind: str, nbytes: int) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        self.counts["collective_bytes"] += self.trips * nbytes
        self.counts[f"coll:{kind}"] += self.trips * nbytes

    def __enter__(self):
        mesh_lib.add_transfer_listener(self._transfer)
        return super().__enter__()

    def __exit__(self, *exc):
        mesh_lib.remove_transfer_listener(self._transfer)
        return super().__exit__(*exc)

    # -- ops -----------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet is _QUERY:
            return out
        inputs = _tensors((args, kwargs))
        outs = _tensors(out)
        self._track(outs, inputs)
        self._note_writes(func, packet, args, kwargs, out)
        if packet in _FREE_OPS or func.is_view:
            return out
        c, n = self.counts, self.trips
        c["launches"] += n
        c["hbm_bytes"] += n * (sum(_nbytes(t) for t in inputs)
                               + sum(_nbytes(t) for t in outs))
        formula = self._flops.get(packet)
        if formula is not None:
            f = n * float(formula(*args, **kwargs, out_val=out))
            c["flops"] += f
            key = "flops:" + _product_dtype(args)
            c[key] = c.get(key, 0.0) + f
        return out


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter` and return its
    counts: the reference's keys (``flops``, ``hbm_bytes``,
    ``collective_bytes``, ``coll:<kind>``) and ``flops:bf16``,
    ``flops:f32``, ``min_bytes``, ``peak_bytes``, ``launches``. Under a
    ``FakeTensorMode`` (the arguments fake tensors of it) nothing is
    allocated."""
    with OpCounter(inputs=(args, kwargs)) as counter:
        out = fn(*args, **kwargs)
    counter.counts["min_bytes"] = float(counter.min_bytes(out))
    del out
    return dict(counter.counts)
