"""Carry weights and state between the JAX package and the port as numpy.

``jax.random`` draws threefry streams that torch cannot reproduce, so parity
runs draw the hash family, the DFO sphere directions and the refine samples
once, hand them over as numpy arrays, and the port replays them. Serving
state crosses the same way: a gateway's warm-start bank (:func:`sketch_bank`)
and a tiered store's slot map and cold tables (:func:`tiered_bank`), and so
do privacy releases: a released sketch (:func:`private_sketch`), mechanism
noise drawn by ``jax.random`` (:func:`noise`) and a view's read plans
(:func:`read_plan`). An LM's parameter tree crosses through
:func:`lm_params`, its decode state through :func:`decode_state` and a
training state (parameters, AdamW moments and master copies, step counters)
through :func:`train_state` (the reference stacks per-cycle arrays on a
leading ``num_cycles`` axis, the port keeps a list of cycles); a checkpoint
directory the reference wrote is read by :func:`read_jax_checkpoint`.
Shape-only trees (``jax.eval_shape``'s) become the port's as meta tensors
(:func:`lm_param_shapes`, :func:`decode_state_shapes`), a reference
``PartitionSpec`` the port's (:func:`partition_spec`), and the gradient
compressor's hash draws cross as arrays (:func:`compression_hashes`). This
module takes and returns numpy only; it never imports JAX.
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lsh import LSHParams
from repro_torch.core.privacy import PrivateSketch, ReadPlan
from repro_torch.core.sketch import Sketch, SketchBank, counter_dtype
from repro_torch.core.tiered import TieredBank
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as model_layers
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import MambaState, RecurrentState
from repro_torch.sharding.specs import PartitionSpec
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def _float_tensor(arr, ndim: int, what: str, device: DeviceLike) -> torch.Tensor:
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if a.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims; got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def lsh_params(projections, device: DeviceLike = None) -> LSHParams:
    """``(R, p, dim)`` projections -> :class:`LSHParams`."""
    return LSHParams(projections=_float_tensor(projections, 3, "projections",
                                               device))


def sketch(counts, n, device: DeviceLike = None) -> Sketch:
    """``(R, B)`` integer counts and the insert count -> :class:`Sketch`.

    The counter dtype is kept (uint16 included: torch stores it, and every
    counter operation of the port widens to int32 first).
    """
    c = np.array(counts)  # a writable copy
    if c.ndim != 2 or c.dtype.kind not in "iu":
        raise ValueError(f"counts must be a 2-D integer array; got "
                         f"{c.dtype} {c.shape}")
    dev = resolve_device(device)
    return Sketch(counts=torch.from_numpy(c).to(dev),
                  n=torch.tensor(int(n), dtype=torch.int32, device=dev))


def sketch_bank(counts, n, device: DeviceLike = None) -> SketchBank:
    """``(S, R, B)`` integer counts and ``(S,)`` insert counts -> bank."""
    c = np.array(counts)  # a writable copy
    if c.ndim != 3 or c.dtype.kind not in "iu":
        raise ValueError(f"counts must be a 3-D integer array; got "
                         f"{c.dtype} {c.shape}")
    nn = np.array(n, dtype=np.int32)
    if nn.shape != c.shape[:1]:
        raise ValueError(f"n must be ({c.shape[0]},); got {nn.shape}")
    dev = resolve_device(device)
    return SketchBank(counts=torch.from_numpy(c).to(dev),
                      n=torch.from_numpy(nn).to(dev))


def tiered_bank(num_tenants: int, hot_capacity: int, rows: int,
                buckets: int, dtype, slot_tenant, cold,
                last_touch=None, touches=None, swap_count: int = 0,
                device: DeviceLike = None) -> TieredBank:
    """A :class:`TieredBank` in a given state (the resident tables live in
    the caller's ``(counts, n)``, e.g. from :func:`sketch_bank`).

    Args:
      dtype: the counter dtype, as a numpy or torch dtype or its name.
      slot_tenant: ``(H,)`` tenant of each slot, ``None`` for a free slot.
      cold: ``{tenant: (counts (R, B), n)}`` spilled tables (landed ones:
        flush the source's evictions first).
      last_touch / touches: ``(H,)`` activity of each slot (default 0).
    """
    name = getattr(dtype, "name", None) or str(dtype).replace("torch.", "")
    tb = TieredBank(num_tenants, hot_capacity, rows, buckets,
                    dtype=counter_dtype(name), device=device)
    if len(slot_tenant) != tb.hot_capacity:
        raise ValueError(f"slot_tenant must have {tb.hot_capacity} entries; "
                         f"got {len(slot_tenant)}")
    tb.slot_tenant = [None if t is None else int(t) for t in slot_tenant]
    tb.slot_of = {t: s for s, t in enumerate(tb.slot_tenant) if t is not None}
    h = tb.hot_capacity
    tb._last_touch = [int(v) for v in (last_touch if last_touch is not None
                                       else [0] * h)]
    tb._touches = [int(v) for v in (touches if touches is not None
                                    else [0] * h)]
    tb.swap_count = int(swap_count)
    for tenant, (c, n) in cold.items():
        tb.load_cold(int(tenant), torch.from_numpy(np.array(c)), int(n))
    return tb


def tiered_to_numpy(tb: TieredBank) -> dict:
    """A :class:`TieredBank`'s state as plain Python and numpy (evictions
    landed first): the keyword arguments of :func:`tiered_bank`."""
    tb.flush_evictions()
    return dict(
        num_tenants=tb.num_tenants, hot_capacity=tb.hot_capacity,
        rows=tb.rows, buckets=tb.buckets, dtype=str(tb.dtype),
        slot_tenant=list(tb.slot_tenant),
        cold={t: (to_numpy(c), int(n)) for t, (c, n) in tb._cold.items()},
        last_touch=list(tb._last_touch), touches=list(tb._touches),
        swap_count=tb.swap_count,
    )


def private_sketch(counts, n, device: DeviceLike = None) -> PrivateSketch:
    """``(R, B)`` released f32 counts and the insert count ->
    :class:`PrivateSketch`."""
    c = _float_tensor(counts, 2, "released counts", device)
    return PrivateSketch(counts=c, n=torch.tensor(int(n), dtype=torch.int32,
                                                  device=c.device))


def noise(arr, device: DeviceLike = None) -> torch.Tensor:
    """A mechanism's f32 draws of any shape (count noise, projection
    normals) -> a tensor, for the ``noise=`` / ``e_s=`` / ``e_t=`` arguments
    of ``core.privacy``."""
    a = np.array(arr, dtype=np.float32)  # a writable copy
    return torch.from_numpy(a).to(resolve_device(device))


def read_plan(plan) -> ReadPlan:
    """A read plan (any object with ``status``, ``noise``, ``n``, ``spent``,
    e.g. the reference view's) -> :class:`ReadPlan`, its noise copied."""
    arr = None if plan.noise is None else np.array(plan.noise, np.float32)
    return ReadPlan(str(plan.status), arr, int(plan.n), bool(plan.spent))


def directions(v, device: DeviceLike = None) -> torch.Tensor:
    """Unit sphere directions ``(steps, F, k, dim)`` for ``dfo.minimize_fleet``."""
    return _float_tensor(v, 4, "directions", device)


def refine_samples(s, device: DeviceLike = None) -> torch.Tensor:
    """Standard normals ``(passes, F, m, dim)`` for the quadratic refine."""
    return _float_tensor(s, 4, "refine samples", device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Any port tensor back to numpy (uint16 counters included)."""
    return t.detach().cpu().numpy()


def lsh_params_to_numpy(params: LSHParams) -> np.ndarray:
    return to_numpy(params.projections)


def sketch_to_numpy(sk: Sketch) -> tuple[np.ndarray, int]:
    return to_numpy(sk.counts), int(sk.n)


def bank_to_numpy(bank: SketchBank) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(bank.counts), to_numpy(bank.n)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def lm_params(tree, cfg: ModelConfig, device: DeviceLike = None) -> dict:
    """The reference's parameter tree (nested dicts of arrays, ``blocks``
    stacked on a leading ``num_cycles`` axis; ``shared`` unstacked) -> the
    port's, in ``cfg.param_dtype`` on ``device``. Weights keep their ``(in,
    out)`` layout, expert stacks their ``(E, in, out)``."""
    return _unstack(tree, cfg, model_layers.dtype_of(cfg.param_dtype),
                    resolve_device(device))


def _leaf(a, dtype: Optional[torch.dtype], dev: torch.device) -> torch.Tensor:
    """A numpy array (an ml_dtypes bfloat16 one through f32: exact) or a
    tensor, in ``dtype`` (``None``: its own) on ``dev``."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(dev, dtype or t.dtype, copy=True)


def _leaves_of(node, dtype: Optional[torch.dtype], dev: torch.device):
    """A subtree of dicts with every leaf through :func:`_leaf`."""
    if isinstance(node, Mapping):
        return {k: _leaves_of(v, dtype, dev) for k, v in node.items()}
    return _leaf(node, dtype, dev)


def _unstack(tree, cfg: ModelConfig, dtype: Optional[torch.dtype],
             dev: torch.device) -> dict:
    """A reference parameter-shaped tree (``blocks`` stacked on a leading
    ``num_cycles`` axis) as the port's (a list of cycles). A position
    without leaves (``shared_attn``'s ``{}``, which a checkpoint's leaf
    paths do not name) is ``{}``."""
    def cycle(node, c):
        if isinstance(node, Mapping):
            return {k: cycle(v, c) for k, v in node.items()}
        return _leaf(node[c], dtype, dev)

    out = {k: _leaves_of(v, dtype, dev) for k, v in tree.items()
           if k != "blocks"}
    blocks = tree["blocks"]
    out["blocks"] = [{f"pos{i}": cycle(blocks.get(f"pos{i}", {}), c)
                      for i in range(len(cfg.cycle))}
                     for c in range(cfg.num_cycles)]
    return out


def _to_numpy_tree(node):
    if isinstance(node, dict):
        return {k: _to_numpy_tree(v) for k, v in node.items()}
    return _f32(node)


def _stack_cycles(nodes):
    """The cycles' trees (dicts, state tuples) as one tree of float32 arrays
    stacked on a leading ``num_cycles`` axis; a state tuple becomes a plain
    tuple."""
    if isinstance(nodes[0], dict):
        return {k: _stack_cycles([n[k] for n in nodes]) for k in nodes[0]}
    if isinstance(nodes[0], tuple):
        return tuple(_stack_cycles([n[j] for n in nodes])
                     for j in range(len(nodes[0])))
    return np.stack([_f32(n) for n in nodes])


def lm_params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`lm_params`: a float32 numpy tree (bf16 values
    exactly) with ``blocks`` stacked on a leading ``num_cycles`` axis."""
    out = {k: _to_numpy_tree(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = _stack_cycles(params["blocks"])
    return out


def _block_state(kind: str, node, c: int, dev: torch.device):
    """Cycle ``c`` of one block's stacked reference state (a named tuple or
    plain tuple of arrays), each leaf in its own dtype: ``(k, v)`` for the
    attention kinds, ``(s, n)`` for mlstm, ``((s, n), conv)`` for mamba."""
    leaf = lambda a: _leaf(a[c] if isinstance(a, torch.Tensor)
                           else np.asarray(a)[c], None, dev)
    if kind == "mlstm":
        return RecurrentState(*(leaf(a) for a in node))
    if kind == "mamba":
        rec, conv = node
        return MambaState(ssm=RecurrentState(*(leaf(a) for a in rec)),
                          conv=leaf(conv))
    return KVCache(*(leaf(a) for a in node))


def decode_state(tree, cfg: ModelConfig, device: DeviceLike = None) -> list:
    """The reference's decode state (``{"pos{i}": state}``, each leaf
    stacked on a leading ``num_cycles`` axis) -> the port's list of cycles
    of :class:`KVCache`, :class:`RecurrentState` and :class:`MambaState`
    on ``device``, every leaf in its own dtype (a bf16 model's caches are
    bf16, the recurrences' states f32, a Mamba conv history either)."""
    dev = resolve_device(device)
    return [{f"pos{i}": _block_state(kind, tree[f"pos{i}"], c, dev)
             for i, kind in enumerate(cfg.cycle)}
            for c in range(cfg.num_cycles)]


def decode_state_to_numpy(state: list) -> dict:
    """Inverse of :func:`decode_state`: ``{"pos{i}": (k, v) | (s, n) |
    ((s, n), conv)}`` of float32 arrays (bf16 values exactly) stacked on a
    leading ``num_cycles`` axis."""
    return _stack_cycles(state)


_META = torch.device("meta")


def _meta_tree(node):
    """A tree of shape-and-dtype leaves (``jax.ShapeDtypeStruct``s or
    arrays) as meta tensors: nothing allocated. Mappings become dicts,
    tuples keep their type."""
    if isinstance(node, Mapping):
        return {k: _meta_tree(v) for k, v in node.items()}
    if isinstance(node, tuple):
        items = [_meta_tree(v) for v in node]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(
            items)
    dtype = getattr(torch, np.dtype(node.dtype).name)
    return torch.empty(tuple(node.shape), dtype=dtype, device=_META)


def lm_param_shapes(tree, cfg: ModelConfig) -> dict:
    """The reference's shape-only parameter tree (``jax.eval_shape`` of
    ``init_params``) -> the port's, as meta tensors, unstacked as
    :func:`lm_params` unstacks (a list of cycles)."""
    return _unstack(_meta_tree(tree), cfg, None, _META)


def decode_state_shapes(tree, cfg: ModelConfig) -> list:
    """The reference's shape-only decode state -> the port's list of cycles
    of meta tensors, as :func:`decode_state` lays it out."""
    meta = _meta_tree(tree)
    return [{f"pos{i}": _block_state(kind, meta[f"pos{i}"], c, _META)
             for i, kind in enumerate(cfg.cycle)}
            for c in range(cfg.num_cycles)]


def partition_spec(spec, stacked: bool = False) -> PartitionSpec:
    """A reference ``PartitionSpec`` (its entries: ``None``, names, tuples
    of names) as the port's; ``stacked`` drops the leading entry of a leaf
    stacked on ``num_cycles`` (the port's leaf is one cycle's)."""
    entries = tuple(spec)
    return PartitionSpec(*(entries[1:] if stacked else entries))


def compression_hashes(buckets, signs, device: DeviceLike = None):
    """The reference compressor's ``(rows, n)`` buckets and signs (its
    ``_hash_params``) -> ``hashes=`` for ``train.compression``: int64 and
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.array(buckets, dtype=np.int64)).to(dev),
            torch.from_numpy(np.array(signs, dtype=np.float32)).to(dev))


def _field(node, name: str):
    """``node.name`` (a named tuple) or ``node[name]`` (a mapping; a missing
    key is ``None``)."""
    if isinstance(node, Mapping):
        return node.get(name)
    return getattr(node, name)


def train_state(tree, cfg: ModelConfig, device: DeviceLike = None
                ) -> ts.TrainStateT:
    """The reference's ``TrainStateT`` (``params``, ``opt`` with ``step``,
    ``mu``, ``nu`` and ``master`` — ``None`` or a tree — and ``step``), as
    named tuples or nested dicts of numpy arrays or tensors -> the port's.
    Parameters are in ``cfg.param_dtype`` and require gradients; moments
    and master copies keep their own dtype (bf16 exactly); the step
    counters are host int32 tensors."""
    dev = resolve_device(device)
    opt = _field(tree, "opt")
    master = _field(opt, "master")
    counter = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32)
    return ts.TrainStateT(
        params=ts.trainable(lm_params(_field(tree, "params"), cfg, dev)),
        opt=opt_lib.AdamWState(
            step=counter(_field(opt, "step")),
            mu=_unstack(_field(opt, "mu"), cfg, None, dev),
            nu=_unstack(_field(opt, "nu"), cfg, None, dev),
            master=None if master is None else _unstack(master, cfg, None,
                                                        dev)),
        step=counter(_field(tree, "step")))


def train_state_to_numpy(state: ts.TrainStateT) -> dict:
    """Inverse of :func:`train_state`: ``{"params", "opt": {"step", "mu",
    "nu", "master"}, "step"}`` with float32 arrays (bf16 values exactly)
    stacked on a leading ``num_cycles`` axis, ``master`` ``None`` or a
    tree, and the counters as ints."""
    opt = state.opt
    return {
        "params": lm_params_to_numpy(state.params),
        "opt": {"step": int(opt.step), "mu": lm_params_to_numpy(opt.mu),
                "nu": lm_params_to_numpy(opt.nu),
                "master": (None if opt.master is None
                           else lm_params_to_numpy(opt.master))},
        "step": int(state.step),
    }


_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _path_keys(name: str) -> list:
    """``".opt.mu['blocks']['pos0']"`` -> ``["opt", "mu", "blocks", "pos0"]``
    (``jax.tree_util.keystr`` names; ``[3]`` gives the int 3)."""
    keys, at = [], 0
    for m in _KEY.finditer(name):
        if m.start() != at:
            break
        keys.append(m.group(1) or m.group(2) if m.group(3) is None
                    else int(m.group(3)))
        at = m.end()
    if at != len(name) or not keys:
        raise ValueError(f"cannot parse leaf path {name!r}")
    return keys


def read_jax_checkpoint(directory: str):
    """The newest intact checkpoint the reference's ``train.checkpoint``
    wrote under ``directory`` (CRCs checked, corrupt ones skipped as its
    ``restore`` skips them), read with numpy and json alone: ``(step, tree,
    metadata)`` with ``tree`` nested dicts by leaf path (a ``TrainStateT``
    gives ``{"params", "opt": {"step", "mu", "nu"[, "master"]}, "step"}``)
    of CPU tensors; bf16 arrays (``'<V2'`` files) bit for bit. Pass it to
    :func:`train_state` to restack ``blocks`` into the port's list.
    Returns ``None`` if there is no intact checkpoint."""
    if not os.path.isdir(directory):
        return None
    loaded = checkpoint.newest_intact(directory)
    if loaded is None:
        return None
    step, arrays, metadata = loaded
    tree: dict = {}
    for name, t in arrays.items():
        *head, last = _path_keys(name)
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return step, tree, metadata
