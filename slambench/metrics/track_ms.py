"""track_ms: median self time (ms) of the fenced span around Tracker.track,
less the mapping span inside it, one a frame."""
from ..harness.stats import percentile, self_times


def read(run):
    if run.spans is None or not run.spans.spans.get("track"):
        return None
    sp = run.spans.spans
    kids = [(a, b) for a, b, _ in sp.get("mapping", [])]
    v = percentile(self_times([(a, b) for a, b, _ in sp["track"]], kids), 50)
    return 1e3 * v
