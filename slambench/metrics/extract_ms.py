"""extract_ms: median host ms of the fenced span around the extractor's
call (HF-Net's pyramid forward and the keypoint post-processing), one a
frame."""
from ..harness.stats import percentile


def read(run):
    if run.spans is None:
        return None
    v = percentile(run.spans.durations("extract"), 50)
    return None if v is None else 1e3 * v
