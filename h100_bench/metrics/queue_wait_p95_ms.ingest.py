"""The nearest-rank 95th percentile of the gateway's ``gateway.queue_wait``
spans in the window (an ingest request's submit to the tick that packs its
last row), in ms: the part of ``ingest_p95_ms`` spent in the queue."""

import math

from h100_bench import harness


def read(run):
    recs = harness.reader_of("idle_in_gateway.ingest").spans(
        run, "gateway.queue_wait")
    if recs is None or not recs.size:
        return None
    waits = sorted((recs["end_ns"] - recs["start_ns"]).tolist())
    return waits[max(0, math.ceil(0.95 * len(waits)) - 1)] / 1e6
