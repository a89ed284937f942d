"""row_top2_roofline: share (%) of the row_top2 kernel's roofline reached in
the traced slices: the least time of the launches made inside the slices
(the program's launch counters, bf_match.shape_launches, read at each
slice's start and stop; harness/stats.row_top2_bound_s: 3 x 2 NA NB D
operations a launch at 495 TFLOP/s) over the kernel's device time there,
found by its name. None where no launch fell in a slice."""
from ..harness.stats import row_top2_bound_s

KERNEL = "row_top2"


def read(run):
    if run.trace is None:
        return None
    launches = {}
    for sl in run.slice_launches:
        for shape, n in sl.items():
            launches[shape] = launches.get(shape, 0) + n
    ns = sum(e - s for name, s, e in run.trace.kernels if KERNEL in name)
    if not launches or ns <= 0:
        return None
    return 100.0 * row_top2_bound_s(launches) / (ns * 1e-9)
