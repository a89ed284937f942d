"""init_frames: median, over the window's episodes, of the frames handed to
the program's monocular initialization (its `init_attempts` counter, one a
frame Tracker._monocular_initialization receives), counted over the
episode's initialization frames as init_ms finds them."""
from ..harness.stats import percentile
from .init_ms import episodes


def read(run):
    eps = episodes(run)
    if eps is None:
        return None
    return percentile([sum((r.counts or {}).get("init_attempts", 0) for r in rs) for rs in eps],
                      50)
