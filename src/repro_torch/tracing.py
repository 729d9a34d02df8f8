"""The port's tracer: host spans and counters inside the program, on the
clock of ``torch.profiler``'s host ranges.

One tracer serves the process. A span is a ``with span(name, key):``
block; it records its name, its start and end in ns, the id of the span
that encloses it on the same thread (each thread keeps its own stack, so
the wire server's handler threads and its engine thread nest apart), and a
key shared by one request's or one tick's spans (-1: none). ``record``
writes a span whose start was stamped earlier (``now()``), such as a
request's time in a queue. ``add(name, n)`` bumps a counter.

**When it records.** Only while it is on: after :func:`enable`, or while a
``torch.profiler`` is recording. Off, a span site costs one flag check and
``torch.autograd._profiler_enabled()``: no clock read, no allocation.

**The clock.** Stamps are ``time.time_ns()``, the wall clock in ns since
the epoch, which is what Kineto stamps host ranges with (torch 2.11 and
2.13 alike). So a span lies on the device trace's timeline: a reader can
put each idle gap between the card's kernels down to the span the host
was in. The program emits no profiler range itself (a
``record_function`` range also appears on the device's timeline).

**Storage.** Records live in flat preallocated arrays of :data:`CAPACITY`
rows (ids, stamps, parents, keys), written in place, so tracing gives the
garbage collector nothing new to walk. A full buffer drops what comes
after and counts it (``summary()["dropped"]``). While it is on, a garbage
collection is a span too (``host.gc``), so the host's time outside every
other span has a name.

**Tallies.** ``tally(name, row, rows, counts)`` adds a device tensor of
counts to row ``row`` of a ``(rows, n)`` int64 tensor kept on that device,
in place: it never waits for the card. :func:`tallies` hands the tensors
out; reading one waits, so read it once, after the window.

**Read-out.** :func:`records` (one structured array), :func:`counters`,
:func:`tallies`, :func:`summary` (count, total, p50 and p99 per span name,
the counters and the drops; JSON-safe), :func:`reset`.
"""

from __future__ import annotations

import gc
import operator
import threading
import time
from typing import Dict, List

import numpy as np
import torch

CAPACITY = 1 << 20  # records; a tick records a few dozen

_profiling = torch.autograd._profiler_enabled
now = time.time_ns

RECORD = np.dtype([("id", np.int64), ("name", object), ("start_ns", np.int64),
                   ("end_ns", np.int64), ("parent", np.int64),
                   ("key", np.int64)])

_enabled = False
_lock = threading.Lock()  # names, counters, reset; never taken by a collection
_names: List[str] = []
_ids: Dict[str, int] = {}
_counters: Dict[str, int] = {}
_tallies: Dict[str, torch.Tensor] = {}
_SLOTS = 1 << 62  # slot numbers a buffer hands out: past its end, a drop


class _Thread(threading.local):
    """Each thread's open spans: ``stack`` holds, per open span, its id and
    the end column it closes into (a ``reset()`` while it is open leaves it
    apart), pushed and popped as one tuple so that a collection's span,
    which may open between any two lines, sees a whole stack; ``in_gc``
    marks a collection's open span."""

    def __init__(self):
        self.stack = []
        self.in_gc = False


_local = _Thread()
_COLUMNS = ("name", "start", "end", "parent", "key")


def _buffers():
    """Fresh record columns (``np.zeros`` pages are touched only as records
    land), and what the writers take in one read: the slot iterator and the
    columns' writable views in :data:`_COLUMNS` order."""
    cols = {c: np.zeros(CAPACITY, np.int64) for c in _COLUMNS}
    return cols, (iter(range(_SLOTS)),) + tuple(
        memoryview(cols[c]) for c in _COLUMNS)


_cols, _buf = _buffers()


def enable() -> None:
    """Record from now on, whether or not a profiler is recording."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while a ``torch.profiler`` is recording."""
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans and counters record now."""
    return _enabled or _profiling()


def _name_id(name: str) -> int:
    i = _ids.get(name)
    if i is None:
        with _lock:
            i = _ids.setdefault(name, len(_names))
            if i == len(_names):
                _names.append(name)
    return i


def _open(name: str, key: int) -> None:
    stack = _local.stack
    slots, names, starts, ends, parents, keys = _buf
    i = next(slots)
    if i < len(names):
        nid = _ids.get(name)
        names[i] = _name_id(name) if nid is None else nid
        parents[i] = stack[-1][0] if stack else -1
        keys[i] = key
        starts[i] = now()  # ends[i] stays 0 while open: records() skips it
    else:
        i = -1
    stack.append((i, ends))


def _close() -> None:
    t = now()
    i, ends = _local.stack.pop()
    if i >= 0:
        ends[i] = t


class _Span:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _close()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_SPAN, _OFF = _Span(), _Off()


def span(name: str, key: int = -1):
    """A context manager timing its block as span ``name``."""
    if not (_enabled or _profiling()):
        return _OFF
    _open(name, key)
    return _SPAN


def record(name: str, start_ns: int, end_ns: int, key: int = -1) -> None:
    """A span stamped by the caller (``start_ns`` from an earlier
    :func:`now`), a child of this thread's innermost open span."""
    if not (_enabled or _profiling()):
        return
    slots, names, starts, ends, parents, keys = _buf
    i = next(slots)
    if i >= len(names):
        return  # a drop
    stack = _local.stack
    nid = _ids.get(name)
    names[i] = _name_id(name) if nid is None else nid
    parents[i] = stack[-1][0] if stack else -1
    keys[i] = key
    starts[i] = start_ns
    ends[i] = end_ns


def add(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``."""
    if not (_enabled or _profiling()):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def tally(name: str, row: int, rows: int, counts: torch.Tensor) -> None:
    """Add ``counts`` (``(n,)``, on any device) to row ``row`` of tally
    ``name``, a ``(rows, n)`` int64 tensor made on ``counts``' device at
    first use; in place, with no wait for the device."""
    if not (_enabled or _profiling()):
        return
    t = _tallies.get(name)
    if t is None:
        with _lock:
            t = _tallies.setdefault(name, torch.zeros(
                (rows, counts.numel()), dtype=torch.int64,
                device=counts.device))
    t[row].add_(counts.to(torch.int64))


def tallies() -> Dict[str, torch.Tensor]:
    """The tallies by name, on their devices (reading one waits for it)."""
    with _lock:
        return dict(_tallies)


def _on_gc(phase: str, info: dict) -> None:
    # A collection runs in whichever thread allocates, also inside this
    # module's ``with _lock:`` blocks: its span takes no lock ("host.gc" is
    # named below, and a drop is only a slot past the buffer's end).
    if phase == "start":
        if _enabled or _profiling():
            _open("host.gc", -1)
            _local.in_gc = True
    elif _local.in_gc:
        _local.in_gc = False
        _close()


_name_id("host.gc")
gc.callbacks.append(_on_gc)


def _closed():
    """The record columns, the slots of their closed records in the order
    they were opened, and the records dropped."""
    with _lock:
        cols, issued = _cols, _SLOTS - operator.length_hint(_buf[0])
    size = cols["end"].size
    idx = np.flatnonzero(cols["end"][:min(issued, size)] > 0)
    return cols, idx, max(0, issued - size)


def records() -> np.ndarray:
    """Every closed record, in the order they were opened, as a structured
    array of :data:`RECORD`: ``id`` (what ``parent`` refers to; -1: no
    parent), ``name``, ``start_ns``, ``end_ns``, ``parent``, ``key``."""
    cols, idx, _ = _closed()
    out = np.empty(idx.size, RECORD)
    out["id"] = idx
    out["name"] = np.array(_names, object)[cols["name"][idx]]
    out["start_ns"] = cols["start"][idx]
    out["end_ns"] = cols["end"][idx]
    out["parent"] = cols["parent"][idx]
    out["key"] = cols["key"][idx]
    return out


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def _rank(ordered: np.ndarray, q: float) -> float:
    """The nearest-rank ``q`` quantile of sorted values."""
    return float(ordered[max(0, int(np.ceil(q * ordered.size)) - 1)])


def summary() -> dict:
    """Per span name: ``count``, ``total_ms``, ``p50_ms``, ``p99_ms``
    (nearest rank); then the counters and the records dropped."""
    cols, idx, dropped = _closed()
    nid = cols["name"][idx]
    ms = (cols["end"][idx] - cols["start"][idx]) / 1e6
    order = np.lexsort((ms, nid))  # by name id, then by length
    ids, first = np.unique(nid[order], return_index=True)
    spans = {}
    for i, part in zip(ids, np.split(ms[order], first[1:])):
        spans[_names[i]] = {"count": int(part.size),
                            "total_ms": float(part.sum()),
                            "p50_ms": _rank(part, 0.5),
                            "p99_ms": _rank(part, 0.99)}
    return {"spans": dict(sorted(spans.items())), "counters": counters(),
            "dropped": dropped}


def reset() -> None:
    """Forget every record, counter, tally and drop. Spans open across a reset
    close into the old buffer."""
    global _cols, _buf
    with _lock:
        _cols, _buf = _buffers()
        _counters.clear()
        _tallies.clear()
