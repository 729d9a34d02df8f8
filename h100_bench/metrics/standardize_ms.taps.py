"""The telemetry bridge's standardization (``bridge.standardize``) and the
readback of its rows (``bridge.readback``), summed over the window, per
batch, in ms: the program's own spans."""

from h100_bench import harness


def read(run):
    recs = harness.reader_of("idle_in_gateway.ingest").spans(
        run, "bridge.standardize", "bridge.readback")
    batches = run.counters.get("batches")
    if recs is None or not recs.size or not batches:
        return None
    return float((recs["end_ns"] - recs["start_ns"]).sum()) / 1e6 / batches
