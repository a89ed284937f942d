"""frame_ms_p95: 95th percentile latency (ms) of every frame finished in
the window (keyframe frames, with local BA and loop detection, show here)."""
from ..harness.stats import percentile


def read(run):
    v = percentile(run.frame_s, 95)
    return None if v is None else 1e3 * v
