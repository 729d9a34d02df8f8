"""The STORM sketch: an ``R x B`` array of integer counters, and banks of
them under one hash family (port of ``repro.core.sketch``).

Insert: each of the ``R`` rows increments the bucket its hash selects. Query:
average the counts at ``[r, code_r]`` over rows and divide by the number of
inserts (RACE estimator); PRP inserts touch two buckets per row, so the
paired query divides by ``2n``.

Narrow counters (int16, uint16, int8) saturate at their range instead of
wrapping. Every counter operation widens to int32 first: torch has no ``add``
for uint16, and a batch of adds must not wrap mid-way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import lsh
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sketch:
    """STORM sketch state.

    Attributes:
      counts: ``(R, B)`` integer counters.
      n: 0-dim int32 tensor: logical inserts (a PRP insert counts 1).
    """

    counts: Tensor
    n: Tensor

    @property
    def rows(self) -> int:
        return self.counts.shape[0]

    @property
    def buckets(self) -> int:
        return self.counts.shape[1]

    def memory_bytes(self) -> int:
        return self.counts.numel() * self.counts.dtype.itemsize + 4


def init_sketch(rows: int, buckets: int, dtype: torch.dtype = torch.int32,
                device=None) -> Sketch:
    """Zeroed sketch; narrow ``dtype`` counters saturate on every insert."""
    return Sketch(
        counts=torch.zeros((rows, buckets), dtype=dtype, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


def _row_ids(codes: Tensor) -> Tensor:
    return torch.arange(codes.shape[-1], device=codes.device).expand(codes.shape)


def counter_dtype(dtype) -> torch.dtype:
    """A counter dtype given as a ``torch.dtype`` or its name (``"int16"``)."""
    out = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if not isinstance(out, torch.dtype) or out.is_floating_point:
        raise ValueError(f"not an integer counter dtype: {dtype!r}")
    return out


def _is_narrow(dtype: torch.dtype) -> bool:
    return dtype.itemsize < 4


def saturating_cast(counts32: Tensor, dtype: torch.dtype) -> Tensor:
    """Cast int32 counts to ``dtype``, clamping at the representable range.

    Counters only grow, so clamping per batch equals clamping the final total.
    """
    info = torch.iinfo(dtype)
    return torch.clamp(counts32, info.min, info.max).to(dtype)


def _widen(counts: Tensor) -> Tensor:
    return counts.to(torch.int32) if _is_narrow(counts.dtype) else counts


def _narrow_back(counts32: Tensor, dtype: torch.dtype) -> Tensor:
    return saturating_cast(counts32, dtype) if _is_narrow(dtype) else counts32


def saturating_add(counts: Tensor, tile: Tensor) -> Tensor:
    """``counts + tile`` in int32, clamped back to ``counts.dtype``."""
    return _narrow_back(_widen(counts) + _widen(tile), counts.dtype)


def _add_codes_(wide: Tensor, codes: Tensor,
                inc: Optional[Tensor] = None) -> None:
    """In place: ``inc[i]`` (default one) more at every ``[r, codes[i, r]]``
    of int32 ``wide``."""
    if inc is None:
        add = torch.ones((), dtype=torch.int32, device=codes.device)
    else:
        add = inc.to(torch.int32)[:, None]
    wide.index_put_((_row_ids(codes), codes.long()), add.expand(codes.shape),
                    accumulate=True)


def _scatter(counts: Tensor, codes: Tensor) -> Tensor:
    """Widened copy of ``counts`` plus one at every ``[r, codes[i, r]]``."""
    wide = _widen(counts).clone()
    _add_codes_(wide, codes)
    return wide


def update(sketch: Sketch, codes: Tensor) -> Sketch:
    """Insert a batch of pre-hashed points, ``codes: (batch, R)``."""
    wide = _scatter(sketch.counts, codes)
    return Sketch(counts=_narrow_back(wide, sketch.counts.dtype),
                  n=sketch.n + codes.shape[0])


def prp_update(sketch: Sketch, codes_pos: Tensor, codes_neg: Tensor) -> Sketch:
    """Paired insert: one logical point increments two buckets per row."""
    wide = _scatter(_scatter(sketch.counts, codes_pos), codes_neg)
    return Sketch(counts=_narrow_back(wide, sketch.counts.dtype),
                  n=sketch.n + codes_pos.shape[0])


def insert(sketch: Sketch, params: lsh.LSHParams, x: Tensor) -> Sketch:
    """Hash-and-insert raw (already scaled) points ``x: (batch, dim)``."""
    return update(sketch, lsh.srp_codes(params, x))


def prp_insert(sketch: Sketch, params: lsh.LSHParams, z: Tensor) -> Sketch:
    """PRP hash-and-insert of pre-scaled concatenated examples ``[x, y]``."""
    return prp_update(sketch, *lsh.prp_codes(params, z))


def merge(a: Sketch, b: Sketch) -> Sketch:
    """Sketch of the union: the elementwise (saturating) sum."""
    return Sketch(counts=saturating_add(a.counts, b.counts), n=a.n + b.n)


def mean_count(gathered: Tensor) -> Tensor:
    """Mean of gathered counts over the last axis, as fp32.

    Integer counts are summed in int64 and converted once, so the sum is
    exact whatever the stream size. Float counts (a privatized release,
    ``core.privacy``) are summed in float64 and converted once: on
    integer-valued tables that equals the integer path bit for bit, and
    fractional parts (the release's noise) are kept. The sum is then scaled
    by the fp32 reciprocal of R, as XLA lowers the reference's
    ``jnp.mean``: for integer sums below 2^24 the two agree bit for bit.
    """
    wide = torch.float64 if gathered.dtype.is_floating_point else torch.int64
    total = gathered.to(wide).sum(-1).to(torch.float32)
    inv_rows = np.float32(1.0) / np.float32(gathered.shape[-1])
    # A Python scalar operand: exact in fp32, and no host->device copy.
    return total * float(inv_rows)


def denominator(n: Tensor, paired: bool) -> Tensor:
    """The RACE divisor: ``max(n, 1)``, doubled for paired sketches."""
    denom = torch.clamp(n.to(torch.float32), min=1.0)
    return 2.0 * denom if paired else denom


def query(sketch: Sketch, codes: Tensor, paired: bool = False) -> Tensor:
    """RACE estimate at query codes ``(..., R)`` -> ``(...,)`` float32."""
    gathered = sketch.counts[_row_ids(codes), codes.long()]
    return mean_count(gathered) / denominator(sketch.n, paired)


def query_theta(sketch: Sketch, params: lsh.LSHParams, theta_tilde: Tensor,
                paired: bool = True) -> Tensor:
    """Surrogate empirical risk estimate at ``theta_tilde = [theta, -1]``."""
    return query(sketch, lsh.query_codes(params, theta_tilde), paired=paired)


@dataclasses.dataclass(frozen=True)
class SketchBank:
    """``S`` sketches under ONE hash family, stacked for one fused query.

    A batched query with a per-point sketch index reads from ``S`` tables in
    one pass; ``select(i)`` is an ordinary :class:`Sketch` and
    :meth:`merge_groups` folds tenant groups by (saturating) addition.

    Attributes:
      counts: ``(S, R, B)`` integer counters, sketch-major.
      n: ``(S,)`` int32 logical inserts per sketch.
    """

    counts: Tensor
    n: Tensor

    @property
    def size(self) -> int:
        return self.counts.shape[0]

    @property
    def rows(self) -> int:
        return self.counts.shape[1]

    @property
    def buckets(self) -> int:
        return self.counts.shape[2]

    def select(self, i: int) -> Sketch:
        """The ``i``-th sketch as a standalone :class:`Sketch` view."""
        return Sketch(counts=self.counts[i], n=self.n[i])

    def merge_groups(self, assignment, num_groups: Optional[int] = None
                     ) -> "SketchBank":
        """``out[g]`` = the sum of the sketches ``i`` with ``assignment[i] == g``.

        Narrow dtypes widen to int32 for the sum and saturate on the way
        back. ``num_groups`` defaults to ``max(assignment) + 1``.
        """
        dev = self.counts.device
        assignment = torch.as_tensor(assignment, dtype=torch.int64,
                                     device=dev)
        g = (int(assignment.max()) + 1 if num_groups is None
             else num_groups)
        wide = torch.zeros((g,) + tuple(self.counts.shape[1:]),
                           dtype=torch.int32, device=dev)
        wide.index_add_(0, assignment, _widen(self.counts))
        n = torch.zeros((g,), dtype=torch.int32, device=dev)
        n.index_add_(0, assignment, self.n.to(torch.int32))
        return SketchBank(counts=_narrow_back(wide, self.counts.dtype), n=n)

    def memory_bytes(self) -> int:
        return (self.counts.numel() * self.counts.dtype.itemsize
                + 4 * self.size)


def bank_of(sketches: Sequence[Sketch]) -> SketchBank:
    """Stack sketches of one shape and dtype into a :class:`SketchBank`.

    They must come from the SAME hash family: the bank stores no params.
    """
    sketches = list(sketches)
    if not sketches:
        raise ValueError("bank_of needs at least one sketch")
    shapes = {tuple(s.counts.shape) for s in sketches}
    dtypes = {s.counts.dtype for s in sketches}
    if len(shapes) != 1 or len(dtypes) != 1:
        raise ValueError(f"bank_of needs homogeneous sketches; got shapes "
                         f"{shapes}, dtypes {dtypes}")
    return SketchBank(
        counts=torch.stack([s.counts for s in sketches]),
        n=torch.stack([torch.as_tensor(s.n, dtype=torch.int32,
                                       device=s.counts.device)
                       for s in sketches]),
    )


def bank_query(bank: SketchBank, codes: Tensor, sketch_idx: Tensor,
               paired: bool = False) -> Tensor:
    """RACE estimate with a per-point sketch index: point ``i`` is
    ``query(bank.select(sketch_idx[i]), codes[i], paired)``.

    Args:
      codes: ``(..., R)`` query codes of the shared hash family.
      sketch_idx: ``(...,)`` integer table index of each point.
    """
    idx = sketch_idx.long()
    gathered = bank.counts[idx[..., None], _row_ids(codes), codes.long()]
    return mean_count(gathered) / denominator(bank.n[idx], paired)


def query_theta_banked(bank: SketchBank, params: lsh.LSHParams,
                       theta_tilde: Tensor, sketch_idx: Tensor,
                       paired: bool = True) -> Tensor:
    """Banked surrogate-risk estimate: one hashed gather serves ``S`` tenants."""
    return bank_query(bank, lsh.query_codes(params, theta_tilde), sketch_idx,
                      paired=paired)


def resolve_engine(engine: str, device: torch.device) -> str:
    """Resolve an engine name to ``scan`` or ``kernel`` for ``device``.

    ``auto`` is the kernel for CUDA tensors and the scan for CPU tensors; the
    one owner of that rule, so insert and query sides agree.
    """
    if engine not in ("auto", "scan", "kernel"):
        raise ValueError(f"unknown engine {engine!r}; use auto | scan | kernel")
    if engine == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "scan"
    return engine


def sketch_dataset(
    params: lsh.LSHParams,
    z: Tensor,
    rows: Optional[int] = None,
    buckets: Optional[int] = None,
    batch: int = 1024,
    paired: bool = True,
    dtype: torch.dtype = torch.int32,
    engine: str = "auto",
    device: DeviceLike = None,
) -> Sketch:
    """One-pass sketch of a pre-scaled dataset ``z: (n, dim)``.

    ``engine="scan"`` hashes ``batch`` rows at a time and scatter-adds their
    codes; ``"kernel"`` sends the whole stream through the fused insert,
    paired or single-sided (``kernels.ops.sketch_stream``: one launch on the
    card). Single-sided rows ``z`` are already augmented.
    The engines agree up to fp sign ties in the projections (a tied point
    moves to another bucket of the same row; row masses are exact). ``z``
    and ``params`` move to ``device`` (``None``: the card, raising without
    one), where the sketch then lives.
    """
    dev = resolve_device(device)
    z = z.to(dev)
    params = lsh.LSHParams(projections=params.projections.to(dev))
    rows = rows if rows is not None else params.rows
    buckets = buckets if buckets is not None else params.buckets
    dtype = counter_dtype(dtype)
    if resolve_engine(engine, z.device) == "kernel":
        if rows != params.rows or buckets != params.buckets:
            raise ValueError(
                "engine='kernel' derives rows/buckets from params; "
                f"got overrides rows={rows}, buckets={buckets}"
            )
        from repro_torch.kernels import ops  # deferred: ops imports this module

        return ops.sketch_stream(params, z, paired=paired, dtype=dtype)
    counts = _scan_insert(params, z, None, rows, buckets, batch, paired)
    n = torch.tensor(z.shape[0], dtype=torch.int32, device=z.device)
    return Sketch(counts=saturating_cast(counts, dtype), n=n)


def _scan_insert(params: lsh.LSHParams, z: Tensor, mask: Optional[Tensor],
                 rows: int, buckets: int, batch: int, paired: bool) -> Tensor:
    """The scan engine's insert: hash ``batch`` rows at a time and
    scatter-add ``int(mask[i])`` (default one) for each; int32 counts.

    The carry is int32 for narrow dtypes and the callers saturate once at
    the end: counters are monotone, so this equals per-batch saturation.
    """
    counts = torch.zeros((rows, buckets), dtype=torch.int32, device=z.device)
    for start in range(0, z.shape[0], batch):
        zb = z[start:start + batch]
        mb = None if mask is None else mask[start:start + batch]
        if paired:
            for codes in lsh.prp_codes(params, zb):
                _add_codes_(counts, codes, mb)
        else:
            _add_codes_(counts, lsh.srp_codes(params, zb), mb)
    return counts


def stack_ragged(zs: Union[Tensor, Sequence[Tensor]]) -> Tuple[Tensor, Tensor]:
    """Stack ragged tenant streams into a mask-padded sketch-major block.

    ``zs`` is an ``(S, n, dim)`` stack (returned as it is, with an all-ones
    mask) or a sequence of ``(n_s, dim)`` tensors; shorter streams are
    zero-padded to the longest and masked out. Returns ``(stacked (S, n_max,
    dim), mask (S, n_max) float32)``, the input of every banked insert.
    """
    if isinstance(zs, torch.Tensor):
        if zs.ndim != 3:
            raise ValueError(f"stacked streams must be (S, n, dim); got "
                             f"shape {tuple(zs.shape)}")
        return zs, torch.ones(zs.shape[:2], dtype=torch.float32,
                              device=zs.device)
    arrs = list(zs)
    if not arrs:
        raise ValueError("need at least one tenant stream")
    dims = {a.shape[-1] for a in arrs}
    if len(dims) != 1 or any(a.ndim != 2 for a in arrs):
        raise ValueError(f"tenant streams must share one (n_s, dim) shape "
                         f"family; got dims {dims}")
    n_max = max(a.shape[0] for a in arrs)
    stacked = torch.stack([
        torch.nn.functional.pad(a, (0, 0, 0, n_max - a.shape[0])) for a in arrs
    ])
    steps = torch.arange(n_max, device=stacked.device)
    mask = torch.stack([(steps < a.shape[0]).to(torch.float32) for a in arrs])
    return stacked, mask


def sketch_dataset_many(
    params: lsh.LSHParams,
    zs: Union[Tensor, Sequence[Tensor]],
    rows: Optional[int] = None,
    buckets: Optional[int] = None,
    batch: int = 1024,
    paired: bool = True,
    dtype: torch.dtype = torch.int32,
    engine: str = "auto",
    device: DeviceLike = None,
) -> SketchBank:
    """Sketch ``S`` datasets under ONE shared hash family into a bank.

    ``zs`` is an ``(S, n, dim)`` stack or a sequence of ``(n_s, dim)``
    streams of unequal lengths (:func:`stack_ragged` mask-pads them). The
    ``kernel`` engine sends the whole masked stack through one banked insert
    (``kernels.ops.sketch_insert_banked``: one launch on the card); the
    ``scan`` engine runs :func:`sketch_dataset`'s scan for each tenant, its
    padding rows adding zero. Slice ``s`` equals the lone
    :func:`sketch_dataset` build of stream ``s`` under the same engine.
    Single-sided streams are already augmented. Runs on ``device``
    (``None``: the card, raising without one).
    """
    dev = resolve_device(device)
    zs = zs.to(dev) if isinstance(zs, torch.Tensor) else [z.to(dev)
                                                           for z in zs]
    zs_stacked, mask = stack_ragged(zs)
    params = lsh.LSHParams(projections=params.projections.to(dev))
    rows = rows if rows is not None else params.rows
    buckets = buckets if buckets is not None else params.buckets
    dtype = counter_dtype(dtype)
    if resolve_engine(engine, dev) == "kernel":
        if rows != params.rows or buckets != params.buckets:
            raise ValueError(
                "engine='kernel' derives rows/buckets from params; "
                f"got overrides rows={rows}, buckets={buckets}"
            )
        from repro_torch.kernels import ops  # deferred: ops imports this module

        return ops.sketch_insert_banked(params, zs_stacked, mask,
                                        paired=paired, dtype=dtype)
    counts = torch.stack([
        _scan_insert(params, zs_stacked[s], mask[s], rows, buckets, batch,
                     paired)
        for s in range(zs_stacked.shape[0])
    ])
    n = mask.to(torch.int32).sum(-1, dtype=torch.int64).to(torch.int32)
    return SketchBank(counts=saturating_cast(counts, dtype), n=n)
