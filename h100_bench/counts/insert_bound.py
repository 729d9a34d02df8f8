"""The least time of the banked paired insert (kernel 4,
``paired_hist_kernel`` of ``csrc/paired_hash_histogram.cu``).

Terms, for ``rows`` rows actually inserted (padded slots are not counted):

* operations: each row is projected on ``R * p`` planes over its
  ``width + 2`` augmented features, one multiply and one add each:
  ``2 * rows * (width + 2) * R * p`` fp32 operations, at 67 TFLOP/s (the
  antithetic side reuses the same accumulator);
* bytes: each row's ``width`` floats and its mask float read once, and per
  launch the hash family ``p * (width + 2) * R`` floats read once and the
  ``tenants * R * 2^p`` int32 counters written once, at 3.35 TB/s.

The bound is the larger of the two.
"""

from __future__ import annotations

from h100_bench.counts import PEAK_FP32_FLOPS, PEAK_HBM_BYTES


def operations(rows: int, width: int, r: int, p: int) -> float:
    return 2.0 * rows * (width + 2) * r * p


def bytes_moved(rows: int, width: int, r: int, p: int, tenants: int,
                launches: int) -> float:
    per_launch = 4.0 * (p * (width + 2) * r + tenants * r * (1 << p))
    return 4.0 * rows * (width + 1) + launches * per_launch


def bound_s(rows: int, width: int, r: int, p: int, tenants: int,
            launches: int) -> float:
    return max(operations(rows, width, r, p) / PEAK_FP32_FLOPS,
               bytes_moved(rows, width, r, p, tenants, launches)
               / PEAK_HBM_BYTES)
