"""The STORM sketch: an ``R x B`` array of integer counters (port of the
lone-sketch half of ``repro.core.sketch``).

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
from typing import Optional

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


def _add_codes_(wide: Tensor, codes: Tensor) -> None:
    """In place: one more at every ``[r, codes[i, r]]`` of int32 ``wide``."""
    ones = torch.ones((), dtype=torch.int32, device=codes.device)
    wide.index_put_((_row_ids(codes), codes.long()), ones.expand(codes.shape),
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


def merge(a: Sketch, b: Sketch) -> Sketch:
    """Sketch of the union: the elementwise (saturating) sum."""
    return Sketch(counts=saturating_add(a.counts, b.counts), n=a.n + b.n)


def mean_count(gathered: Tensor) -> Tensor:
    """Mean of gathered integer counts over the last axis, as fp32.

    The sum is taken in int64 and converted once, so it is exact whatever the
    stream size. It is then scaled by the fp32 reciprocal of R, as XLA lowers
    the reference's ``jnp.mean``: below 2^24 the two agree bit for bit.
    """
    total = gathered.to(torch.int64).sum(-1).to(torch.float32)
    inv_rows = np.float32(1.0) / np.float32(gathered.shape[-1])
    return total * torch.tensor(inv_rows, device=gathered.device)


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
    codes; ``"kernel"`` sends the whole stream through the fused paired
    insert (``kernels.ops.sketch_stream``: one launch on the card).
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
    # The carry is int32 for narrow dtypes and saturates once at the end:
    # counters are monotone, so this equals per-batch saturation.
    counts = torch.zeros((rows, buckets), dtype=torch.int32, device=z.device)
    for start in range(0, z.shape[0], batch):
        zb = z[start:start + batch]
        if paired:
            for codes in lsh.prp_codes(params, zb):
                _add_codes_(counts, codes)
        else:
            _add_codes_(counts, lsh.srp_codes(params, zb))
    n = torch.tensor(z.shape[0], dtype=torch.int32, device=z.device)
    return Sketch(counts=saturating_cast(counts, dtype), n=n)
