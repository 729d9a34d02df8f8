"""The loop's ``ingest_p95_ms`` (submit to acknowledging report, every
ingest request of the window, host clock), read in the traced run, where the
host paces it."""


def read(run):
    return run.window_metrics.get("ingest_p95_ms")
