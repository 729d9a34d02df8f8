"""Kernel 4's share of its roofline, as ``insert_roofline.ingest`` reads it,
in the cells where it moves ``card_rows_per_s``."""

from h100_bench import harness


def read(run):
    return harness.reader_of("insert_roofline.ingest").read(run)
