"""Frozen operation and byte counts, and the H100's published peaks.

The counts follow the algorithm's equations in their least form, from the
shapes alone, so that the same work reads the same whatever implements it.
``frozen.json`` holds their values at the cells' shapes; a test holds the
functions to it.
"""

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
