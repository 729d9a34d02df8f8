"""Kernel 4's share of its roofline in the traced window: its least time for
the rows actually inserted (``counts/insert_bound.py``) over its device time
(the profiler's records of ``paired_hist_kernel``), in %."""

from h100_bench.counts import insert_bound


def read(run):
    us, launches = run.kernel_us("paired_hist_kernel")
    c = run.counters
    if not us or not c.get("inserted_rows"):
        return None
    bound = insert_bound.bound_s(c["inserted_rows"], c["row_width"],
                                 c["hash_rows"], c["planes"], c["tenants"],
                                 launches)
    return 100.0 * bound / (us / 1e6)
