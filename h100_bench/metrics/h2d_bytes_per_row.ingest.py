"""Bytes the gateway copied from pinned staging to the card per row it
packed, from the program's counters ``gateway.h2d_bytes`` and
``gateway.rows_packed`` (counted while the profiler records: the window and
its drain). Full ingest slots read 44 B/row (11 float32 words)."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    rows = c.get("gateway.rows_packed")
    return c["gateway.h2d_bytes"] / rows if rows else None
