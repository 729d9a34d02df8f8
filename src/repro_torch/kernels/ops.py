"""Dispatch over the port's kernels (port of ``repro.kernels.ops``).

``mode`` is one of:

* ``auto``: the kernel wrapper, which launches the CUDA kernel for CUDA
  tensors and runs the plain version for CPU tensors;
* ``kernel``: the same wrapper, but a CPU tensor raises;
* ``ref``: the plain PyTorch version on any device.

The weight layout here is the kernels' plane-major ``(p, d, R)``;
:func:`from_lsh_params` converts from the core library's ``(R, p, d)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import lsh, sketch as sketch_lib
from repro_torch.kernels import ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import srp_hash as hash_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel

Tensor = torch.Tensor

MODES = ("auto", "kernel", "ref")


def _plain(mode: str, t: Tensor) -> bool:
    """True when ``mode`` selects the plain version for tensor ``t``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; use auto | kernel | ref")
    if mode == "kernel" and t.device.type != "cuda":
        raise ValueError(f"mode='kernel' needs CUDA tensors; got {t.device}")
    return mode == "ref"


def from_lsh_params(params: lsh.LSHParams) -> Tensor:
    """Core-layout projections ``(R, p, d)`` -> kernel layout ``(p, d, R)``."""
    return params.projections.permute(1, 2, 0).contiguous()


def srp_hash(x: Tensor, w: Tensor, mode: str = "auto") -> Tensor:
    """Bucket codes ``(n, R)`` int32 of ``x: (n, d)`` under ``w: (p, d, R)``.

    ``repro.kernels.ops.srp_hash`` takes the Pallas kernel only from
    ``d >= 64`` off the TPU; here every CUDA call is one launch of the
    Hopper kernel, whatever ``d``.
    """
    x = x.to(torch.float32).contiguous()
    if _plain(mode, x):
        return ref.srp_hash(x, w)
    return hash_kernel.srp_hash(x, w.to(torch.float32).contiguous())


def _ones_mask(shape, device) -> Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def _mask_count(mask: Tensor) -> Tensor:
    """Logical inserts of a masked stream (per tenant for an ``(S, n)``
    mask): the sum of ``int(mask[i])``."""
    return mask.to(torch.int32).sum(-1, dtype=torch.int64).to(torch.int32)


def _insert(lone, plain, x: Tensor, w: Tensor, mask: Tensor, mode: str,
            out_dtype: torch.dtype) -> Tensor:
    """One insert through ``lone`` (the kernel wrapper) or ``plain``.

    uint16 has no kernel output: it saturates the int32 table once.
    """
    if out_dtype == torch.uint16:
        return sketch_lib.saturating_cast(
            _insert(lone, plain, x, w, mask, mode, torch.int32), out_dtype)
    x = x.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return (plain if _plain(mode, x) else lone)(x, w, mask, out_dtype)


def paired_hash_histogram(
    z: Tensor, w: Tensor, mask: Optional[Tensor] = None, mode: str = "auto",
    out_dtype: torch.dtype = torch.int32,
) -> Tensor:
    """Fused antithetic PRP insert: ``(R, 2**p)`` counts of the masked stream.

    ``z`` is pre-scaled but NOT augmented; ``w`` lives in the augmented space
    ``(p, d + 2, R)``.
    """
    if mask is None:
        mask = _ones_mask(z.shape[:1], z.device)
    return _insert(histogram_kernel.paired_hash_histogram,
                   ref.paired_hash_histogram, z, w, mask, mode, out_dtype)


def hash_histogram(
    x: Tensor, w: Tensor, mask: Optional[Tensor] = None, mode: str = "auto",
    out_dtype: torch.dtype = torch.int32,
) -> Tensor:
    """Single-sided insert: ``(R, 2**p)`` counts of the masked stream.

    ``x`` is pre-scaled and already augmented; ``w`` is ``(p, d, R)``.
    """
    if mask is None:
        mask = _ones_mask(x.shape[:1], x.device)
    return _insert(histogram_kernel.hash_histogram, ref.hash_histogram, x, w,
                   mask, mode, out_dtype)


def paired_hash_histogram_banked(
    z: Tensor, w: Tensor, mask: Optional[Tensor] = None, mode: str = "auto",
    out_dtype: torch.dtype = torch.int32,
) -> Tensor:
    """Banked PRP insert of an ``(S, n, d)`` stack: ``(S, R, 2**p)`` counts.

    One shared hash family; slice ``s`` equals
    ``paired_hash_histogram(z[s], w, mask[s])``.
    """
    if mask is None:
        mask = _ones_mask(z.shape[:2], z.device)
    return _insert(histogram_kernel.paired_hash_histogram_banked,
                   ref.paired_hash_histogram_banked, z, w, mask, mode,
                   out_dtype)


def hash_histogram_banked(
    x: Tensor, w: Tensor, mask: Optional[Tensor] = None, mode: str = "auto",
    out_dtype: torch.dtype = torch.int32,
) -> Tensor:
    """Banked single-sided insert of an ``(S, n, d)`` stack of augmented
    rows: ``(S, R, 2**p)``; slice ``s`` equals ``hash_histogram(x[s], w,
    mask[s])``."""
    if mask is None:
        mask = _ones_mask(x.shape[:2], x.device)
    return _insert(histogram_kernel.hash_histogram_banked,
                   ref.hash_histogram_banked, x, w, mask, mode, out_dtype)


def sketch_query(q: Tensor, w: Tensor, counts: Tensor, mode: str = "auto",
                 sketch_idx: Optional[Tensor] = None,
                 index_checked: bool = False) -> Tensor:
    """Batched RACE query: ``(m,)`` mean counts at the query codes.

    Any batch size goes to the kernel. With ``sketch_idx`` (``(m,)``
    integers) the query is banked: ``counts`` is an ``(S, R, B)`` stack and
    point ``i`` reads table ``sketch_idx[i]``; ``index_checked``, where the
    caller has checked the index range on the host, spares the kernel
    wrapper its read of it (``sketch_query.sketch_query_banked``). uint16
    counters (which the kernel does not read) are widened to int32 first;
    float32 tables (a privatized release) take the kernel's f32 variant.
    """
    if (sketch_idx is not None) != (counts.ndim == 3) or counts.ndim not in (
            2, 3):
        raise ValueError(f"banked (S, R, B) counts go with a sketch_idx and "
                         f"(R, B) counts without one; got shape "
                         f"{tuple(counts.shape)}, sketch_idx "
                         f"{'given' if sketch_idx is not None else 'None'}")
    if counts.dtype == torch.uint16:
        counts = counts.to(torch.int32)
    q = q.to(torch.float32).contiguous()
    plain = _plain(mode, q)
    if sketch_idx is None:
        if plain:
            return ref.sketch_query(q, w, counts)
        return query_kernel.sketch_query(q, w, counts.contiguous())
    if plain:
        return ref.sketch_query_banked(q, w, counts, sketch_idx)
    return query_kernel.sketch_query_banked(q, w, counts.contiguous(),
                                            sketch_idx, index_checked)


def build_sketch(
    params: lsh.LSHParams, z: Tensor, mask: Optional[Tensor] = None,
    paired: bool = True, mode: str = "auto",
) -> sketch_lib.Sketch:
    """One-shot fused sketch of pre-scaled data ``z`` (int32 counts; PRP
    when paired, else ``z`` is already augmented)."""
    return sketch_stream(params, z, mask, paired=paired, mode=mode)


def query_theta_with_weights(
    sk, w: Tensor, theta_tilde: Tensor, paired: bool = True,
    mode: str = "auto", sketch_idx: Optional[Tensor] = None,
    index_checked: bool = False,
) -> Tensor:
    """Surrogate-risk estimate with pre-transposed kernel weights.

    ``w`` is the ``(p, d, R)`` layout from :func:`from_lsh_params`. Sessions
    that query one frozen hash many times (a fit's DFO steps) convert the
    layout once and pass ``w`` to every call.

    ``sk`` may be a :class:`~repro_torch.core.sketch.SketchBank`; then
    ``sketch_idx`` (``(m,)``, one entry per row of a 2-D ``theta_tilde``)
    routes each point to its table, and the denominator is that sketch's
    own ``n`` (doubled when paired); ``index_checked`` as in
    :func:`sketch_query`.
    """
    banked = isinstance(sk, sketch_lib.SketchBank)
    if banked != (sketch_idx is not None):
        raise ValueError("sketch_idx must be given iff sk is a SketchBank")
    q = lsh.augment_query(lsh.normalize_query(theta_tilde))
    if banked:
        if theta_tilde.ndim != 2:
            raise ValueError("banked queries need a (m, dim) theta batch")
        mean = sketch_query(q, w, sk.counts, mode=mode, sketch_idx=sketch_idx,
                            index_checked=index_checked)
        n_per = sk.n[sketch_idx.long()]
    else:
        mean = sketch_query(torch.atleast_2d(q), w, sk.counts, mode=mode)
        n_per = sk.n
    est = mean / sketch_lib.denominator(n_per, paired)
    return est[0] if theta_tilde.ndim == 1 else est


def query_theta(
    sk: sketch_lib.Sketch, params: lsh.LSHParams, theta_tilde: Tensor,
    paired: bool = True, mode: str = "auto",
) -> Tensor:
    """Fused surrogate-risk estimate; converts the weight layout per call."""
    return query_theta_with_weights(sk, from_lsh_params(params), theta_tilde,
                                    paired=paired, mode=mode)


def sketch_stream(
    params: lsh.LSHParams,
    z: Tensor,
    mask: Optional[Tensor] = None,
    paired: bool = True,
    mode: str = "auto",
    dtype: torch.dtype = torch.int32,
) -> sketch_lib.Sketch:
    """Stream a whole dataset through one fused insert (paired or
    single-sided; for single-sided inserts ``z`` is already augmented).

    ``repro.kernels.ops.sketch_stream`` scans batches with a saturating carry.
    Integer adds commute and the saturation is monotone, so one launch over
    the whole masked stream gives the same counts (up to the projections'
    sign ties) at the cost of one launch.
    """
    if mask is None:
        mask = _ones_mask(z.shape[:1], z.device)
    insert = paired_hash_histogram if paired else hash_histogram
    counts = insert(z, from_lsh_params(params), mask, mode=mode,
                    out_dtype=dtype)
    return sketch_lib.Sketch(counts=counts, n=_mask_count(mask))


def sketch_insert_banked(
    params: lsh.LSHParams,
    zs: Tensor,
    mask: Optional[Tensor] = None,
    paired: bool = True,
    mode: str = "auto",
    dtype: torch.dtype = torch.int32,
) -> sketch_lib.SketchBank:
    """Sketch ``S`` tenant streams under one shared hash family in one launch.

    ``zs: (S, n, dim)`` is a sketch-major stack (ragged tenants mask-padded by
    ``core.sketch.stack_ragged``); masked rows are hashed but add nothing,
    and each tenant's ``n`` is its mask mass. ``repro.kernels.ops`` scans
    batches of the stack; one launch over the whole masked stack gives the
    same counts, as in :func:`sketch_stream`. Slice ``s`` equals
    ``sketch_stream(params, zs[s], mask[s])``.
    """
    if mask is None:
        mask = _ones_mask(zs.shape[:2], zs.device)
    insert = paired_hash_histogram_banked if paired else hash_histogram_banked
    counts = insert(zs, from_lsh_params(params), mask, mode=mode,
                    out_dtype=dtype)
    return sketch_lib.SketchBank(counts=counts, n=_mask_count(mask))
