"""Batched RACE query: hash, gather, mean over rows (port of
``repro.kernels.sketch_query``: ``sketch_query`` and ``sketch_query_banked``).

On CUDA tensors the wrappers launch the Hopper kernel in
``csrc/sketch_query.cu`` (its source note says what bounds it and how it is
laid out); on CPU tensors they run the plain PyTorch versions in ``ref``.
There is no fallback from one to the other.

The kernel splits the R rows across blocks and adds each block's int64
partial sums into a per-point workspace; the last block of a point tile
writes the means and sets its part of the workspace back to zero. The
workspace (:func:`_workspace`) is kept per device and stream and grown on
demand, so a call makes one launch and no other CUDA operation. Every
launch runs with the current device set to its tensors' device: the grid's
SM count is read from the current device.

Tables of f32 (a privatized release, ``core.privacy``) go to the kernel's
f32 variant, :func:`sketch_query_f32` and :func:`sketch_query_banked_f32`
(``sketch_query`` and ``sketch_query_banked`` hand them on, and each counts
its own launches). It sums in float64 with a fixed order: each block
writes one partial per (row slice, point) into a float64 workspace
(:func:`_partials`), and the last block of a point tile adds them up.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, ref

Tensor = torch.Tensor

_COUNT_BYTES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
MAX_PLANES = 30

# (device index, stream handle) -> (int64 point sums, int32 tile tickets)
_WORKSPACES: Dict[Tuple[int, int], Tuple[Tensor, Tensor]] = {}
# (device index, stream handle) -> float64 partials of the f32 variant
_PARTIALS: Dict[Tuple[int, int], Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("sketch_query")
    lone = lib.storm_sketch_query
    lone.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    banked = lib.storm_sketch_query_banked
    banked.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    lone.restype = banked.restype = ctypes.c_int
    lone32 = lib.storm_sketch_query_f32
    lone32.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    banked32 = lib.storm_sketch_query_banked_f32
    banked32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    lone32.restype = banked32.restype = ctypes.c_int
    lib.storm_sketch_query_partials.argtypes = [ctypes.c_int] * 4
    lib.storm_sketch_query_partials.restype = ctypes.c_longlong
    return lib


def _workspace(device: torch.device, stream: int, m: int
               ) -> Tuple[Tensor, Tensor]:
    """The query kernel's workspace on ``(device, stream)`` for ``m`` points:
    at least ``m`` int64 sums and ``m`` int32 tickets (a point tile holds
    one point or more), all zero between launches (each launch leaves them
    so). Grown, zeroed, when a call needs more; launches on one stream run
    in order, so they share it.
    """
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < m:
        cap = max(m, 4096, 2 * ws[0].numel() if ws is not None else 0)
        ws = (torch.zeros(cap, dtype=torch.int64, device=device),
              torch.zeros(cap, dtype=torch.int32, device=device))
        _WORKSPACES[key] = ws
    return ws


@functools.lru_cache(maxsize=256)
def _partials_needed(device_index: int, m: int, d: int, p: int,
                     rows: int) -> int:
    """float64 partials of one f32 query: one per (row slice, point), as
    the kernel plans its grid on the device (the SM count sets it)."""
    need = _lib().storm_sketch_query_partials(m, d, p, rows)
    if need < 0:
        raise RuntimeError("sketch_query_f32: could not read the device's "
                           "SM count")
    return need


def _partials(device: torch.device, stream: int, need: int) -> Tensor:
    """The f32 variant's float64 workspace on ``(device, stream)``, at least
    ``need`` long. Every entry a launch reads it wrote first, so it is
    never zeroed; grown (once, without a host read) when a call needs
    more."""
    key = (device.index, stream)
    ws = _PARTIALS.get(key)
    if ws is None or ws.numel() < need:
        cap = max(need, 1 << 16, 2 * ws.numel() if ws is not None else 0)
        ws = torch.empty(cap, dtype=torch.float64, device=device)
        _PARTIALS[key] = ws
    return ws


def _check_cuda(q: Tensor, w: Tensor, counts: Tensor) -> None:
    if not (q.device == w.device == counts.device):
        raise ValueError(f"q, w and counts must share one device; got "
                         f"{q.device}, {w.device}, {counts.device}")
    for name, t in (("q", q), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32; got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
    if (counts.dtype not in _COUNT_BYTES and counts.dtype != torch.float32
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be contiguous int32, int16, int8 or "
                         f"float32; got {counts.dtype}")
    if q.ndim != 2 or w.ndim != 3 or q.shape[1] != w.shape[1]:
        raise ValueError(f"need q (m, d), w (p, d, R); got {tuple(q.shape)}, "
                         f"{tuple(w.shape)}")
    p, _, rows = w.shape
    if not 1 <= p <= MAX_PLANES or counts.shape[-2:] != (rows, 1 << p):
        raise ValueError(f"counts must end in (R, 2**p) = ({rows}, {1 << p}) "
                         f"with 1 <= p <= {MAX_PLANES}; got "
                         f"{tuple(counts.shape)}")


def _on_cuda(q: Tensor) -> bool:
    """False for CPU tensors (plain version); raises for any other device."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def sketch_query(q: Tensor, w: Tensor, counts: Tensor) -> Tensor:
    """``(m,)`` fp32 mean over rows of ``counts[r, code_r(q)]``.

    Args:
      q: ``(m, d)`` query vectors (already normalized and augmented).
      w: ``(p, d, R)`` hyperplane normals.
      counts: ``(R, 2**p)`` int32, int16 or int8 counters, or a float32
        table (handed to :func:`sketch_query_f32`).
    """
    if counts.dtype == torch.float32:
        return sketch_query_f32(q, w, counts)
    if not _on_cuda(q):
        return ref.sketch_query(q, w, counts)
    _check_cuda(q, w, counts)
    if counts.ndim != 2:
        raise ValueError(f"counts must be (R, B); got {tuple(counts.shape)}")
    p, d, rows = w.shape
    m = q.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=q.device)
    if not m:
        return out  # nothing to query: no launch
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sums, tickets = _workspace(q.device, stream, m)
    with torch.cuda.device(q.device):  # the grid's SM count: this device's
        code = lib.storm_sketch_query(
            q.data_ptr(), w.data_ptr(), counts.data_ptr(), out.data_ptr(),
            sums.data_ptr(), tickets.data_ptr(), m, d, p, rows,
            _COUNT_BYTES[counts.dtype], stream,
        )
    _build.check(code, lib, "sketch_query")
    sketch_query.launches += 1
    return out


def sketch_query_banked(q: Tensor, w: Tensor, counts: Tensor,
                        sketch_idx: Tensor,
                        index_checked: bool = False) -> Tensor:
    """``(m,)`` fp32: point ``i`` is the mean of table ``sketch_idx[i]``.

    Args:
      q: ``(m, d)`` query vectors (already normalized and augmented).
      w: ``(p, d, R)`` hyperplane normals, shared by the bank.
      counts: ``(S, R, 2**p)`` int32, int16 or int8 counters, or float32
        tables (handed to :func:`sketch_query_banked_f32`).
      sketch_idx: ``(m,)`` integer table index per point, each in ``[0, S)``.
      index_checked: the caller has made sure, on the host, that every
        entry of ``sketch_idx`` lies in ``[0, S)``. Then nothing is read
        back from the device, and a wrong entry is an out-of-range read on
        the card, not an error: the caller is responsible for the range.
        ``False`` checks the entries here, at one read back to the host
        per call.
    """
    if counts.dtype == torch.float32:
        return sketch_query_banked_f32(q, w, counts, sketch_idx,
                                       index_checked)
    idx = _bank_index(q, counts, sketch_idx, index_checked)
    if not _on_cuda(q):
        return ref.sketch_query_banked(q, w, counts, idx)
    _check_cuda(q, w, counts)
    p, d, rows = w.shape
    m = q.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=q.device)
    if not m:
        return out  # nothing to query: no launch
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sums, tickets = _workspace(q.device, stream, m)
    with torch.cuda.device(q.device):
        code = lib.storm_sketch_query_banked(
            q.data_ptr(), w.data_ptr(), counts.data_ptr(), idx.data_ptr(),
            out.data_ptr(), sums.data_ptr(), tickets.data_ptr(), m, d, p,
            rows, _COUNT_BYTES[counts.dtype], stream,
        )
    _build.check(code, lib, "sketch_query_banked")
    sketch_query_banked.launches += 1
    return out


def _bank_index(q: Tensor, counts: Tensor, sketch_idx: Tensor,
                index_checked: bool) -> Tensor:
    """``sketch_idx`` as contiguous int32, its range checked unless the
    caller has (``index_checked``)."""
    if counts.ndim != 3 or sketch_idx.shape != (q.shape[0],):
        raise ValueError(f"need counts (S, R, B) and sketch_idx (m,); got "
                         f"{tuple(counts.shape)}, {tuple(sketch_idx.shape)}")
    if sketch_idx.dtype.is_floating_point or sketch_idx.device != q.device:
        raise ValueError(f"sketch_idx must be an integer tensor on "
                         f"{q.device}; got {sketch_idx.dtype} on "
                         f"{sketch_idx.device}")
    idx = sketch_idx.to(torch.int32).contiguous()
    if not index_checked and idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= counts.shape[0]:
            raise ValueError(f"sketch_idx must lie in [0, {counts.shape[0]});"
                             f" got {lo}..{hi}")
    return idx


def _launch_f32(q: Tensor, w: Tensor, counts: Tensor, idx) -> Tensor:
    """One launch of the f32 variant (``idx`` None: the lone query)."""
    _check_cuda(q, w, counts)
    if counts.dtype != torch.float32:
        raise ValueError(f"counts must be float32; got {counts.dtype}")
    p, d, rows = w.shape
    m = q.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=q.device)
    if not m:
        return out  # nothing to query: no launch
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _, tickets = _workspace(q.device, stream, m)
    with torch.cuda.device(q.device):  # the grid plan reads its SM count
        partials = _partials(q.device, stream, _partials_needed(
            q.device.index, m, d, p, rows))
        if idx is None:
            code = lib.storm_sketch_query_f32(
                q.data_ptr(), w.data_ptr(), counts.data_ptr(),
                out.data_ptr(), partials.data_ptr(), tickets.data_ptr(), m,
                d, p, rows, stream)
        else:
            code = lib.storm_sketch_query_banked_f32(
                q.data_ptr(), w.data_ptr(), counts.data_ptr(),
                idx.data_ptr(), out.data_ptr(), partials.data_ptr(),
                tickets.data_ptr(), m, d, p, rows, stream)
    _build.check(code, lib, "sketch_query_f32" if idx is None
                 else "sketch_query_banked_f32")
    return out


def sketch_query_f32(q: Tensor, w: Tensor, counts: Tensor) -> Tensor:
    """:func:`sketch_query` over a float32 table ``(R, 2**p)``: the mean of
    the gathered values, summed in float64, converted once, scaled by
    fp32(1/R). Two launches give the same bits; an integer-valued table
    gives the integer query's result bit for bit."""
    if not _on_cuda(q):
        return ref.sketch_query(q, w, counts)
    if counts.ndim != 2:
        raise ValueError(f"counts must be (R, B); got {tuple(counts.shape)}")
    out = _launch_f32(q, w, counts, None)
    if q.shape[0]:
        sketch_query_f32.launches += 1
    return out


def sketch_query_banked_f32(q: Tensor, w: Tensor, counts: Tensor,
                            sketch_idx: Tensor,
                            index_checked: bool = False) -> Tensor:
    """:func:`sketch_query_banked` over float32 tables ``(S, R, 2**p)``,
    summed as :func:`sketch_query_f32` sums."""
    idx = _bank_index(q, counts, sketch_idx, index_checked)
    if not _on_cuda(q):
        return ref.sketch_query_banked(q, w, counts, idx)
    out = _launch_f32(q, w, counts, idx)
    if q.shape[0]:
        sketch_query_banked_f32.launches += 1
    return out


sketch_query.launches = 0
sketch_query_banked.launches = 0
sketch_query_f32.launches = 0
sketch_query_banked_f32.launches = 0
