"""Fused paired hash + histogram: the STORM insert (port of
``repro.kernels.storm_sketch.paired_hash_histogram``).

On CUDA tensors the wrapper launches the Hopper kernel in
``csrc/paired_hash_histogram.cu`` (its source note says what bounds it and
how it is laid out); on CPU tensors it runs the plain PyTorch version,
``ref.paired_hash_histogram``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

_OUT_BYTES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
MAX_PLANES = 8
MAX_FEATURES = 32  # d: the kernel keeps a row's weights in registers


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("paired_hash_histogram")
    fn = lib.storm_paired_hash_histogram
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda(z: Tensor, w: Tensor, mask: Tensor, out_dtype) -> None:
    if not (z.device == w.device == mask.device):
        raise ValueError(f"z, w and mask must share one device; got "
                         f"{z.device}, {w.device}, {mask.device}")
    for name, t in (("z", z), ("w", w), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32; got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if z.ndim != 2 or w.ndim != 3 or mask.shape != (z.shape[0],):
        raise ValueError(f"need z (n, d), w (p, d+2, R), mask (n,); got "
                         f"{tuple(z.shape)}, {tuple(w.shape)}, "
                         f"{tuple(mask.shape)}")
    p, d_aug, _ = w.shape
    if d_aug != z.shape[1] + 2:
        raise ValueError(f"w has {d_aug} features; z needs {z.shape[1] + 2}")
    if not 1 <= p <= MAX_PLANES or z.shape[1] > MAX_FEATURES:
        raise ValueError(f"the kernel takes 1 <= p <= {MAX_PLANES} and "
                         f"d <= {MAX_FEATURES}; got p={p}, d={z.shape[1]}")
    if out_dtype not in _OUT_BYTES:
        raise ValueError(f"out_dtype must be int32, int16 or int8; got "
                         f"{out_dtype}")


def paired_hash_histogram(z: Tensor, w: Tensor, mask: Tensor,
                          out_dtype: torch.dtype = torch.int32) -> Tensor:
    """Antithetic PRP insert of a masked stream: ``(R, 2**p)`` counts.

    Args:
      z: ``(n, d)`` pre-scaled points (``|z| <= 1``; NOT augmented).
      w: ``(p, d + 2, R)`` hyperplane normals of the augmented space.
      mask: ``(n,)`` validity mask in {0, 1}.
      out_dtype: int32, or int16/int8 saturated once at the end.

    One launch takes the whole stream: counts only grow, so a single
    saturation of the total equals the per-batch saturating scan.
    """
    if z.device.type == "cpu":
        return ref.paired_hash_histogram(z, w, mask, out_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _check_cuda(z, w, mask, out_dtype)
    p, _, rows = w.shape
    hist = torch.zeros((rows, 1 << p), dtype=torch.int32, device=z.device)
    out = hist if out_dtype == torch.int32 else torch.empty_like(
        hist, dtype=out_dtype)
    lib = _lib()
    code = lib.storm_paired_hash_histogram(
        z.data_ptr(), w.data_ptr(), mask.data_ptr(), hist.data_ptr(),
        out.data_ptr(), z.shape[0], z.shape[1], p, rows,
        _OUT_BYTES[out_dtype], torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(code, lib, "paired_hash_histogram")
    paired_hash_histogram.launches += 1
    return out


paired_hash_histogram.launches = 0
