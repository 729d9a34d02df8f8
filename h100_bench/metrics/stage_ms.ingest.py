"""The median over the window's ticks of the host's time writing a tick's
traffic into pinned staging (the gateway's ``gateway.stage`` spans, summed
within each ``gateway.tick_start``), in ms."""

import collections
import statistics

from h100_bench import harness


def read(run):
    recs = harness.reader_of("idle_in_gateway.ingest").spans(
        run, "gateway.stage")
    if recs is None or not recs.size:
        return None
    per_tick = collections.defaultdict(int)
    for parent, s, e in zip(recs["parent"], recs["start_ns"], recs["end_ns"]):
        per_tick[int(parent)] += int(e - s)
    return statistics.median(per_tick.values()) / 1e6
