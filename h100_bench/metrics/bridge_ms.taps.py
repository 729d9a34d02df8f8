"""Host time in the telemetry bridge's sink per batch, its flushes into the
gateway included, in ms: the mean over the window's batches of the loop's
span around the call (the median would read only the batches that buffer
without a flush)."""


def read(run):
    times = run.spans.get("bridge")
    return 1e3 * sum(times) / len(times) if times else None
