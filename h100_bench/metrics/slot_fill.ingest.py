"""Rows acknowledged in the window over the ingest slots the window's ticks
shipped (ticks x tenants x ingest slots), in %."""


def read(run):
    c = run.counters
    slots = c.get("ticks", 0) * c.get("tenants", 0) * c.get("ingest_slots", 0)
    return 100.0 * c["rows"] / slots if slots else None
