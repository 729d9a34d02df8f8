"""Dispatch over the port's kernels (port of the lone-sketch half of
``repro.kernels.ops``).

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


def _ones_mask(n: int, device) -> Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def _mask_count(mask: Tensor) -> Tensor:
    """Logical inserts of a masked stream: the sum of ``int(mask[i])``."""
    return mask.to(torch.int32).sum(dtype=torch.int64).to(torch.int32)


def paired_hash_histogram(
    z: Tensor, w: Tensor, mask: Optional[Tensor] = None, mode: str = "auto",
    out_dtype: torch.dtype = torch.int32,
) -> Tensor:
    """Fused antithetic PRP insert: ``(R, 2**p)`` counts of the masked stream.

    ``z`` is pre-scaled but NOT augmented; ``w`` lives in the augmented space
    ``(p, d + 2, R)``.
    """
    if mask is None:
        mask = _ones_mask(z.shape[0], z.device)
    if out_dtype == torch.uint16:  # no kernel output: saturate the int32 table
        return sketch_lib.saturating_cast(
            paired_hash_histogram(z, w, mask, mode=mode), out_dtype)
    z = z.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    if _plain(mode, z):
        return ref.paired_hash_histogram(z, w, mask, out_dtype)
    return histogram_kernel.paired_hash_histogram(z, w, mask, out_dtype)


def sketch_query(q: Tensor, w: Tensor, counts: Tensor, mode: str = "auto"
                 ) -> Tensor:
    """Batched RACE query: ``(m,)`` mean counts at the query codes.

    Any batch size goes to the kernel. uint16 counters (which the kernel
    does not read) are widened to int32 first.
    """
    if counts.ndim != 2:
        raise ValueError(f"counts must be (R, B); got shape "
                         f"{tuple(counts.shape)} (banked queries are not "
                         "ported yet)")
    if counts.dtype == torch.uint16:
        counts = counts.to(torch.int32)
    q = q.to(torch.float32).contiguous()
    if _plain(mode, q):
        return ref.sketch_query(q, w, counts)
    return query_kernel.sketch_query(q, w, counts.contiguous())


def build_sketch(
    params: lsh.LSHParams, z: Tensor, mask: Optional[Tensor] = None,
    mode: str = "auto",
) -> sketch_lib.Sketch:
    """One-shot fused paired sketch of pre-scaled data ``z`` (int32 counts)."""
    return sketch_stream(params, z, mask, mode=mode)


def query_theta_with_weights(
    sk: sketch_lib.Sketch, w: Tensor, theta_tilde: Tensor, paired: bool = True,
    mode: str = "auto",
) -> Tensor:
    """Surrogate-risk estimate with pre-transposed kernel weights.

    ``w`` is the ``(p, d, R)`` layout from :func:`from_lsh_params`. Sessions
    that query one frozen hash many times (a fit's DFO steps) convert the
    layout once and pass ``w`` to every call.
    """
    q = lsh.augment_query(lsh.normalize_query(theta_tilde))
    mean = sketch_query(torch.atleast_2d(q), w, sk.counts, mode=mode)
    est = mean / sketch_lib.denominator(sk.n, paired)
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
    """Stream a whole dataset through the fused paired insert.

    ``repro.kernels.ops.sketch_stream`` scans batches with a saturating carry.
    Integer adds commute and the saturation is monotone, so one launch over
    the whole masked stream gives the same counts (up to the projections'
    sign ties) at the cost of one launch.
    """
    if not paired:
        raise NotImplementedError(
            "single-sided inserts (hash_histogram) are not ported yet")
    if mask is None:
        mask = _ones_mask(z.shape[0], z.device)
    counts = paired_hash_histogram(z, from_lsh_params(params), mask,
                                   mode=mode, out_dtype=dtype)
    return sketch_lib.Sketch(counts=counts, n=_mask_count(mask))
