"""Batched RACE query: hash, gather, mean over rows (port of
``repro.kernels.sketch_query.sketch_query``).

On CUDA tensors the wrapper launches the Hopper kernel in
``csrc/sketch_query.cu`` (its source note says what bounds it and how it is
laid out); on CPU tensors it runs the plain PyTorch version,
``ref.sketch_query``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

_COUNT_BYTES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
MAX_PLANES = 30


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("sketch_query")
    fn = lib.storm_sketch_query
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda(q: Tensor, w: Tensor, counts: Tensor) -> None:
    if not (q.device == w.device == counts.device):
        raise ValueError(f"q, w and counts must share one device; got "
                         f"{q.device}, {w.device}, {counts.device}")
    for name, t in (("q", q), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32; got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if counts.dtype not in _COUNT_BYTES or not counts.is_contiguous():
        raise ValueError(f"counts must be contiguous int32, int16 or int8; "
                         f"got {counts.dtype}")
    if q.ndim != 2 or w.ndim != 3 or q.shape[1] != w.shape[1]:
        raise ValueError(f"need q (m, d), w (p, d, R); got {tuple(q.shape)}, "
                         f"{tuple(w.shape)}")
    p, _, rows = w.shape
    if not 1 <= p <= MAX_PLANES or counts.shape != (rows, 1 << p):
        raise ValueError(f"counts must be (R, 2**p) = ({rows}, {1 << p}) "
                         f"with 1 <= p <= {MAX_PLANES}; got "
                         f"{tuple(counts.shape)}")


def sketch_query(q: Tensor, w: Tensor, counts: Tensor) -> Tensor:
    """``(m,)`` fp32 mean over rows of ``counts[r, code_r(q)]``.

    Args:
      q: ``(m, d)`` query vectors (already normalized and augmented).
      w: ``(p, d, R)`` hyperplane normals.
      counts: ``(R, 2**p)`` int32, int16 or int8 counters.
    """
    if q.device.type == "cpu":
        return ref.sketch_query(q, w, counts)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, w, counts)
    p, d, rows = w.shape
    out = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.storm_sketch_query(
        q.data_ptr(), w.data_ptr(), counts.data_ptr(), out.data_ptr(),
        q.shape[0], d, p, rows, _COUNT_BYTES[counts.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(code, lib, "sketch_query")
    sketch_query.launches += 1
    return out


sketch_query.launches = 0
