"""frame_ms_p50: median latency (ms) of every frame finished in the window."""
from ..harness.stats import percentile


def read(run):
    v = percentile(run.frame_s, 50)
    return None if v is None else 1e3 * v
