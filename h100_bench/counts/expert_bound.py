"""The least time of a dropless MoE layer's two routed expert products
(``moe.dropless_moe``'s grouped products, up then down) over ``rows``
routed (token, choice) rows.

Terms, for ``rows`` rows, width ``d`` and expert width ``ff``:

* operations: each row through its expert's up (``d x ff``) and down
  (``ff x d``) products, one multiply and one add each: ``4 * rows * d *
  ff`` bf16 operations, at 989 TFLOP/s;
* bytes: every expert's two bf16 matrices read once, ``experts * 2 * d *
  ff * 2``; each row read once by the up product (``d``) and written once
  by it (``ff``), and read once by the down product (``ff``) and written
  once by it (``d``), in bf16: ``rows * 2 * (d + ff) * 2``, at 3.35 TB/s.

The bound is the larger of the two. The relu^2 between the products is not
counted.
"""

from __future__ import annotations

from h100_bench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def operations(rows: int, d: int, ff: int) -> float:
    return 4.0 * rows * d * ff


def bytes_moved(rows: int, d: int, ff: int, experts: int) -> float:
    return 4.0 * experts * d * ff + 4.0 * rows * (d + ff)


def bound_s(rows: int, d: int, ff: int, experts: int) -> float:
    return max(operations(rows, d, ff) / PEAK_BF16_FLOPS,
               bytes_moved(rows, d, ff, experts) / PEAK_HBM_BYTES)
