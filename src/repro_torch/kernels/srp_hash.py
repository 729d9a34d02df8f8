"""SRP hashing: ``(n, R)`` int32 bucket codes (port of
``repro.kernels.srp_hash``).

On CUDA tensors :func:`srp_hash` launches the Hopper kernel in
``csrc/srp_hash.cu`` (its source note says what bounds it and how it is laid
out); on CPU tensors it runs the plain PyTorch version in ``ref``. There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

MAX_PLANES = 30  # codes are int32 bit fields


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("srp_hash")
    fn = lib.storm_srp_hash
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda(x: Tensor, w: Tensor) -> None:
    if x.device != w.device:
        raise ValueError(f"x and w must share one device; got {x.device}, "
                         f"{w.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32; got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (n, d), w (p, d, R); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    p, d, rows = w.shape
    if not 1 <= p <= MAX_PLANES or d < 1 or rows < 1:
        raise ValueError(f"the kernel takes 1 <= p <= {MAX_PLANES}, d >= 1 "
                         f"and R >= 1; got p={p}, d={d}, R={rows}")
    if x.shape[0] >= 1 << 31 or rows >= 1 << 31:
        raise ValueError(f"too many points or rows: {tuple(x.shape)}, R={rows}")


def srp_hash(x: Tensor, w: Tensor) -> Tensor:
    """``codes[i, r] = sum_j (x_i . w[j, :, r] > 0) << j``, ``(n, R)`` int32.

    Args:
      x: ``(n, d)`` float32 points.
      w: ``(p, d, R)`` float32 hyperplane normals, ``p <= 30``.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cpu":
        return ref.srp_hash(x, w)
    _check_cuda(x, w)
    p, d, rows = w.shape
    out = torch.empty((x.shape[0], rows), dtype=torch.int32, device=x.device)
    if not x.shape[0]:
        return out  # nothing to hash: no launch
    lib = _lib()
    with torch.cuda.device(x.device):  # the launch acts on the current device
        code = lib.storm_srp_hash(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], d, p,
            rows, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, lib, "srp_hash")
    srp_hash.launches += 1
    return out


srp_hash.launches = 0
