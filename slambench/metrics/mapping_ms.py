"""mapping_ms: median host ms of LocalMapper.process_keyframe (triangulation,
fusion, local BA, culling), one a keyframe."""
from ..harness.stats import percentile


def read(run):
    if run.spans is None:
        return None
    v = percentile(run.spans.durations("mapping"), 50)
    return None if v is None else 1e3 * v
