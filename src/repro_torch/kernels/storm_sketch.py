"""Fused hash + histogram: the STORM inserts (port of
``repro.kernels.storm_sketch``).

Four wrappers, one per TPU kernel: the paired (PRP) insert and the
single-sided insert, each for one stream and for a tenant stack under one
shared hash family. On CUDA tensors each launches its Hopper kernel
(``csrc/paired_hash_histogram.cu`` and ``csrc/hash_histogram.cu``; their
source notes say what bounds them and how they are laid out); on CPU tensors
it runs the plain PyTorch version in ``ref``. There is no fallback from one to
the other. Rows of up to 32 features with p <= 8 take the narrow bodies (a
hash row's weights in registers); wider rows and more planes take the wide
body, the projection tile of ``csrc/projection_tile.cuh``, which streams the
features through shared memory, so the kernels take any d and p up to 30 on
the card, as the reference's Pallas inserts tile any width.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

_OUT_BYTES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
MAX_PLANES = 30  # codes are int32 bit fields
MAX_TENANTS = 65535  # the grid's z extent


@functools.cache
def _lib(stem: str) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu`` with both entry points typed."""
    lib = _build.library(stem)
    lone = getattr(lib, f"storm_{stem}")
    lone.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    banked = getattr(lib, f"storm_{stem}_banked")
    banked.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    lone.restype = banked.restype = ctypes.c_int
    return lib


def _check_cuda(x: Tensor, w: Tensor, mask: Tensor, out_dtype,
                paired: bool, banked: bool) -> None:
    if not (x.device == w.device == mask.device):
        raise ValueError(f"points, w and mask must share one device; got "
                         f"{x.device}, {w.device}, {mask.device}")
    for name, t in (("points", x), ("w", w), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32; got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    ndim = 3 if banked else 2
    if x.ndim != ndim or w.ndim != 3 or mask.shape != x.shape[:-1]:
        lead = "S, n" if banked else "n"
        raise ValueError(f"need points ({lead}, d), w (p, d', R), mask "
                         f"({lead}); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(mask.shape)}")
    d = x.shape[-1]
    p, d_w, _ = w.shape
    want = d + 2 if paired else d
    if d_w != want:
        raise ValueError(f"w has {d_w} features; the points need {want}")
    if not 1 <= p <= MAX_PLANES:
        raise ValueError(f"the kernel takes 1 <= p <= {MAX_PLANES}; got "
                         f"p={p}")
    if x.shape[-2] >= 1 << 31 or (banked and x.shape[0] > MAX_TENANTS):
        raise ValueError(f"too many points or tenants: {tuple(x.shape)}")
    if out_dtype not in _OUT_BYTES:
        raise ValueError(f"out_dtype must be int32, int16 or int8; got "
                         f"{out_dtype}")


def _launch(stem: str, x: Tensor, w: Tensor, mask: Tensor, out_dtype,
            paired: bool, banked: bool) -> Tensor:
    """Check, allocate the zeroed int32 tables, and launch one insert."""
    _check_cuda(x, w, mask, out_dtype, paired, banked)
    p, _, rows = w.shape
    lead = x.shape[:1] if banked else ()
    hist = torch.zeros(lead + (rows, 1 << p), dtype=torch.int32,
                       device=x.device)
    out = hist if out_dtype == torch.int32 else torch.empty_like(
        hist, dtype=out_dtype)
    lib = _lib(stem)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), mask.data_ptr(), hist.data_ptr(),
            out.data_ptr())
    dims = (x.shape[-2], x.shape[-1], p, rows, _OUT_BYTES[out_dtype])
    # The launch, the grid's SM count and the shared-memory opt-in act on
    # the current device: make it the tensors' device.
    with torch.cuda.device(x.device):
        if banked:
            code = getattr(lib, f"storm_{stem}_banked")(
                *ptrs, x.shape[0], *dims, stream)
        else:
            code = getattr(lib, f"storm_{stem}")(*ptrs, *dims, stream)
    _build.check(code, lib, stem + ("_banked" if banked else ""))
    return out


def _on_cuda(x: Tensor) -> bool:
    """False for CPU tensors (plain version); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def paired_hash_histogram(z: Tensor, w: Tensor, mask: Tensor,
                          out_dtype: torch.dtype = torch.int32) -> Tensor:
    """Antithetic PRP insert of a masked stream: ``(R, 2**p)`` counts.

    Args:
      z: ``(n, d)`` pre-scaled points (``|z| <= 1``; NOT augmented).
      w: ``(p, d + 2, R)`` hyperplane normals of the augmented space.
      mask: ``(n,)`` mask; point ``i`` adds ``int(mask[i])`` (1 for a
        valid slot, 0 for padding; other integers weight the point).
      out_dtype: int32, or int16/int8 saturated once at the end.

    One launch takes the whole stream: counts only grow, so a single
    saturation of the total equals the per-batch saturating scan.
    """
    if not _on_cuda(z):
        return ref.paired_hash_histogram(z, w, mask, out_dtype)
    out = _launch("paired_hash_histogram", z, w, mask, out_dtype,
                  paired=True, banked=False)
    paired_hash_histogram.launches += z.shape[-2] > 0  # empty: no launch
    return out


def hash_histogram(x: Tensor, w: Tensor, mask: Tensor,
                   out_dtype: torch.dtype = torch.int32) -> Tensor:
    """Single-sided insert of a masked stream: ``(R, 2**p)`` counts.

    Args:
      x: ``(n, d)`` pre-scaled and already augmented points
        (``lsh.augment_data``).
      w: ``(p, d, R)`` hyperplane normals.
      mask: ``(n,)`` validity mask in {0, 1}.
      out_dtype: int32, or int16/int8 saturated once at the end.
    """
    if not _on_cuda(x):
        return ref.hash_histogram(x, w, mask, out_dtype)
    out = _launch("hash_histogram", x, w, mask, out_dtype, paired=False,
                  banked=False)
    hash_histogram.launches += x.shape[-2] > 0  # empty: no launch
    return out


def paired_hash_histogram_banked(z: Tensor, w: Tensor, mask: Tensor,
                                 out_dtype: torch.dtype = torch.int32
                                 ) -> Tensor:
    """:func:`paired_hash_histogram` over a tenant stack in one launch.

    ``z: (S, n, d)``, ``mask: (S, n)``, one shared ``w``; slice ``s`` of the
    ``(S, R, 2**p)`` result equals the lone insert of ``z[s], mask[s]``.
    """
    if not _on_cuda(z):
        return ref.paired_hash_histogram_banked(z, w, mask, out_dtype)
    out = _launch("paired_hash_histogram", z, w, mask, out_dtype,
                  paired=True, banked=True)
    paired_hash_histogram_banked.launches += z.shape[-2] > 0  # empty: no launch
    return out


def hash_histogram_banked(x: Tensor, w: Tensor, mask: Tensor,
                          out_dtype: torch.dtype = torch.int32) -> Tensor:
    """:func:`hash_histogram` over a tenant stack in one launch.

    ``x: (S, n, d)`` (already augmented), ``mask: (S, n)``, one shared
    ``w``; slice ``s`` of the ``(S, R, 2**p)`` result equals the lone insert
    of ``x[s], mask[s]``.
    """
    if not _on_cuda(x):
        return ref.hash_histogram_banked(x, w, mask, out_dtype)
    out = _launch("hash_histogram", x, w, mask, out_dtype, paired=False,
                  banked=True)
    hash_histogram_banked.launches += x.shape[-2] > 0  # empty: no launch
    return out


paired_hash_histogram.launches = 0
hash_histogram.launches = 0
paired_hash_histogram_banked.launches = 0
hash_histogram_banked.launches = 0
