"""The share of the traced window's device-idle time (the complement of
the card's busy intervals) that the host spent inside the gateway's own
``gateway.tick_start`` or ``gateway.tick_finish`` spans, in %.

The program's tracer (``repro_torch.tracing``) records while the profiler
does, stamped on the profiler's clock, so its spans and the card's kernels
share one timeline. :func:`spans`, :func:`idle_intervals`,
:func:`covered_share` and :func:`idle_share` serve the other readers of
the tracer; a program without it reads ``None``."""

import numpy as np


def spans(run, *names):
    """The tracer's records named ``names`` that lie inside the traced
    window (``start_ns`` and ``end_ns`` in ns), or ``None`` without the
    tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    recs = tracing.records()
    lo, hi = (t * 1e3 for t in run.window_us)
    named = np.fromiter((n in names for n in recs["name"]), bool, recs.size)
    return recs[named & (recs["start_ns"] >= lo) & (recs["end_ns"] <= hi)]


def idle_intervals(run):
    """The window's idle intervals ``(start, end)`` in µs: between the
    card's busy intervals and the window's edges."""
    lo, hi = run.window_us
    idle, prev = [], lo
    for s, e in run.busy_intervals():
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        idle.append((prev, hi))
    return idle


def covered_share(run, intervals):
    """The share, in %, of the window's idle time covered by the union of
    ``intervals`` (``(start, end)`` in µs); ``None`` without idle time."""
    idle = idle_intervals(run)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    cover = []
    for s, e in sorted(intervals):
        if cover and s <= cover[-1][1]:
            cover[-1][1] = max(cover[-1][1], e)
        else:
            cover.append([s, e])
    covered, j = 0.0, 0
    for s, e in idle:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < e:
            covered += min(e, cover[k][1]) - max(s, cover[k][0])
            k += 1
    return 100.0 * covered / total


def idle_share(run, *names):
    """The share, in %, of the window's idle time covered by the union of
    the spans ``names``; ``None`` without such spans or idle time."""
    recs = spans(run, *names)
    if recs is None or not recs.size:
        return None
    return covered_share(run, zip(recs["start_ns"] / 1e3,
                                  recs["end_ns"] / 1e3))


def read(run):
    return idle_share(run, "gateway.tick_start", "gateway.tick_finish")
