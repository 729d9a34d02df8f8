"""Rows inserted into the tenants' counters over the seconds in which a
kernel or a copy ran on the card, in the profiled window and its drain: the
card's time per row of ingest, which the host's pace does not move."""


def read(run):
    rows = run.counters.get("inserted_rows")
    busy = run.busy_s
    return rows / busy if rows and busy > 0 else None
