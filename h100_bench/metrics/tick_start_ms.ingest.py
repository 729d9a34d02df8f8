"""Median host time of ``StormGateway.tick_start`` per tick, in ms, from the
loop's span around the call."""

import statistics


def read(run):
    times = run.spans.get("tick_start")
    return statistics.median(times) * 1e3 if times else None
