"""Arithmetic of the benchmark's numbers: percentiles, roofline shares,
span self times, and the H100's data-sheet peaks."""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit (the
# port's tools/peaks.py)
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12


def row_top2_bound_s(launches):
    """The least seconds the card could take for row_top2 launches
    {(NA, NB, D): count}: 3 x 2 NA NB D operations a launch (its 3xTF32
    products) at the TF32 peak; its bytes never bind."""
    return sum(3.0 * 2.0 * a * b * d * n for (a, b, d), n in launches.items()) / H100_TF32_FLOPS


def percentile(values, q):
    """q-th percentile (0-100) with linear interpolation between order
    statistics (numpy's default)."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def roofline_pct(flops, nbytes, seconds, peak_flops, peak_bytes=H100_BYTES_PER_S):
    """Share (%) of the least time the chip could take for `flops`
    operations and `nbytes` bytes (the larger of the two bounds) in the
    `seconds` the work took."""
    if seconds <= 0:
        return None
    return 100.0 * max(flops / peak_flops, nbytes / peak_bytes) / seconds


def self_times(parents, children):
    """Each parent span's duration minus the time its child spans cover;
    spans are (start, end) pairs and children never overlap each other."""
    out = []
    kids = sorted(children)
    for p0, p1 in parents:
        inner = sum(min(c1, p1) - max(c0, p0) for c0, c1 in kids if c0 < p1 and c1 > p0)
        out.append((p1 - p0) - inner)
    return out
