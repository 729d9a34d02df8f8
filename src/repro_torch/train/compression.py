"""Count-sketch gradient compression for the cross-pod all-reduce (port of
``repro.train.compression``).

Count sketches are linear, ``sketch(g1) + sketch(g2) = sketch(g1 + g2)``,
so each pod sketches its gradient, the pods sum the small sketches over the
slow cross-pod links, and each unsketches the sum (FetchSGD, Rothchild et
al. 2020): the median of the rows' signed estimates, then the top-k
coordinates by magnitude. What a pod failed to send (its gradient plus its
old residual, minus the estimate it applied) is carried into the next step
(error feedback).

The hash family is the port's own. The reference draws ``(rows, n)``
buckets and signs from threefry on every call, which torch cannot
reproduce, and which at a model's size (n = 1e9, 5 rows) would take 40 GB.
Here each ``(bucket, sign)`` is a fixed function of ``(seed, row,
coordinate)``, a counter-based integer hash computed where the vector lives
(:func:`_hash_params`), made ``HASH_CHUNK`` coordinates at a time; sketch
and unsketch see the same draws. Every function takes the draws injected as
``hashes=(buckets, signs)`` too, so tests run the reference's.

Sums: the sketch adds each row's contributions with ``scatter_add_``; on
the card the adds are atomics whose order varies between runs, so a bucket
is exact only to its f32 rounding (at most ``(m - 1) 2^-24`` times the sum
of its ``m`` entries' magnitudes). The median takes the middle of the rows
sorted, and the mean of the two middles when ``rows`` is even, as
``jnp.median`` does (``torch.median`` takes the lower one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.sharding.mesh import Mesh
from repro_torch.train import tree as tree_lib

Tensor = torch.Tensor
Hashes = Tuple[Tensor, Tensor]

# Coordinates hashed at a time: 5 rows of int64 temporaries of 32 MiB each.
HASH_CHUNK = 1 << 22
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SketchCompressorConfig:
    rows: int = 5                 # median-of-rows estimator
    cols: int = 1 << 18           # sketch width per row
    top_k_fraction: float = 0.01  # fraction of coordinates kept at unsketch
    seed: int = 17


class CompressorState(NamedTuple):
    residual: Any  # error-feedback tree, same structure as grads


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for ``0 <= x < 2^32``, in int64 without
    overflow (``c`` split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (Wellons' ``lowbias32``), on Python ints
    or int64 tensors holding values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_params(cfg: SketchCompressorConfig, lo: int, hi: int,
                 device: torch.device) -> Hashes:
    """Coordinates ``[lo, hi)``'s ``(buckets (rows, hi - lo) int64, signs
    (rows, hi - lo) f32 of +-1)``: ``h = mix(c_lo ^ mix(c_hi ^ key_row))``
    over the coordinate's 32-bit halves, ``bucket = h % cols``, the sign
    from the top bit of ``mix(h ^ K)``."""
    keys = torch.tensor([[_mix32((cfg.seed * 0x9E3779B9 + r) & _M32)]
                         for r in range(cfg.rows)], dtype=torch.int64,
                        device=device)
    c = torch.arange(lo, hi, dtype=torch.int64, device=device)
    h = _mix32((c & _M32) ^ _mix32((c >> 32) ^ keys))       # (rows, chunk)
    buckets = h % cfg.cols
    signs = 1.0 - 2.0 * (_mix32(h ^ 0x68E31DA4) >> 31).to(torch.float32)
    return buckets, signs


def _chunks(cfg: SketchCompressorConfig, n: int, device: torch.device,
            hashes: Optional[Hashes]):
    """``(lo, hi, buckets, signs)`` over ``[0, n)`` a chunk at a time: the
    injected arrays' columns, or :func:`_hash_params`'s."""
    for lo in range(0, n, HASH_CHUNK):
        hi = min(n, lo + HASH_CHUNK)
        if hashes is None:
            yield (lo, hi) + _hash_params(cfg, lo, hi, device)
        else:
            yield (lo, hi, hashes[0][:, lo:hi].to(device, torch.int64),
                   hashes[1][:, lo:hi].to(device, torch.float32))


def sketch_vector(cfg: SketchCompressorConfig, vec: Tensor,
                  hashes: Optional[Hashes] = None) -> Tensor:
    """Dense ``(n,)`` -> count sketch ``(rows, cols)`` in ``vec``'s dtype,
    on its device. Linear in ``vec``."""
    sk = torch.zeros((cfg.rows, cfg.cols), dtype=vec.dtype, device=vec.device)
    for lo, hi, buckets, signs in _chunks(cfg, vec.shape[0], vec.device,
                                          hashes):
        sk.scatter_add_(1, buckets, vec[None, lo:hi] * signs)
    return sk


def unsketch_vector(cfg: SketchCompressorConfig, sk: Tensor, n: int,
                    hashes: Optional[Hashes] = None) -> Tensor:
    """The median-of-rows estimate of every coordinate, then only those
    whose magnitude reaches the k-th largest (``k = max(1, int(n *
    top_k_fraction))``; ties at the threshold kept, as ``>=``)."""
    est = torch.empty((n,), dtype=sk.dtype, device=sk.device)
    mid_lo, mid_hi = (cfg.rows - 1) // 2, cfg.rows // 2
    for lo, hi, buckets, signs in _chunks(cfg, n, sk.device, hashes):
        vals = (sk.gather(1, buckets) * signs).sort(dim=0).values
        est[lo:hi] = (vals[mid_lo] + vals[mid_hi]) * 0.5
    k = max(1, int(n * cfg.top_k_fraction))
    mag = est.abs()
    thresh = torch.topk(mag, k, sorted=False).values.min()
    return torch.where(mag >= thresh, est, 0.0)


def init_state(grads_template: Any) -> CompressorState:
    """Zero residuals in f32 beside every gradient leaf."""
    return CompressorState(residual=tree_lib.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_template))


def _flat(grads: Any, state: CompressorState) -> Tensor:
    """``grads + residual`` in f32, flattened in leaf order."""
    return torch.cat([(g.to(torch.float32) + r.to(torch.float32)).reshape(-1)
                      for g, r in zip(tree_lib.leaves(grads),
                                      tree_lib.leaves(state.residual))])


def _unflat(grads: Any, est: Tensor, residual: Tensor
            ) -> Tuple[Any, CompressorState]:
    """The estimate in each leaf's shape and dtype, and the residual in
    f32, as trees like ``grads``."""
    outs, res, off = [], [], 0
    for g in tree_lib.leaves(grads):
        n = g.numel()
        outs.append(est[off:off + n].reshape(g.shape).to(g.dtype))
        res.append(residual[off:off + n].reshape(g.shape))
        off += n
    return (tree_lib.unflatten(grads, outs),
            CompressorState(residual=tree_lib.unflatten(grads, res)))


def compress_allreduce(cfg: SketchCompressorConfig, grads: Any,
                       state: Any, mesh: Optional[Mesh] = None,
                       hashes: Optional[Hashes] = None):
    """Error-feedback sketch, the sum of the sketches over the pods, and
    the unsketch.

    Without a mesh: one pod; ``grads`` a tree and ``state`` its
    :class:`CompressorState`; returns ``(estimate tree, new state)``: the
    sketch round trip alone. With a one-axis mesh (the reference's
    ``"pod"`` axis): ``grads`` and ``state`` are sequences, one per shard,
    on their shards' devices. Each shard sketches ``grads + residual``; the
    sketches are summed in shard order on the mesh's first device (the
    reference's ``psum``), ``denom`` is the shard count; each shard gets
    the estimate ``unsketch(sum) / denom`` and the residual ``flat - est *
    denom`` (what it failed to send). Returns ``([estimate tree], [new
    state])`` per shard. The traffic is ``rows * cols`` floats a step,
    whatever the model's size."""
    if mesh is None:
        flat = _flat(grads, state)
        est = unsketch_vector(cfg, sketch_vector(cfg, flat, hashes),
                              flat.shape[0], hashes)
        return _unflat(grads, est, flat - est)
    grads, state = list(grads), list(state)
    if not len(grads) == len(state) == mesh.size:
        raise ValueError(f"compress_allreduce over {mesh.size} shards needs "
                         f"one gradient tree and one state each; got "
                         f"{len(grads)} and {len(state)}")
    flats = [_flat(g, s) for g, s in zip(grads, state)]
    sk = None
    for flat in flats:
        part = sketch_vector(cfg, flat, hashes).to(mesh.first)
        sk = part if sk is None else sk + part
    denom = float(mesh.size)
    est = unsketch_vector(cfg, sk, flats[0].shape[0], hashes) / denom
    outs: List[Tuple[Any, CompressorState]] = []
    for g, flat, dev in zip(grads, flats, mesh.devices):
        e = est.to(dev)
        outs.append(_unflat(g, e, flat - e * denom))
    return [o[0] for o in outs], [o[1] for o in outs]


def compression_ratio(cfg: SketchCompressorConfig, n_params: int) -> float:
    return n_params / float(cfg.rows * cfg.cols)
