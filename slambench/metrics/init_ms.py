"""init_ms: median, over the window's episodes, of the host ms an episode's
initialization frames spent in the program's `track.init` span (Tracker:
the monocular initialization with its children `track.init.search`,
`track.init.twoview` and `track.init.map`). The frames are the program's
`frame` spans that lie inside the (t0, t1) the feed recorded around each of
an episode's first `init_frames` frames (its `init_log`), which precede the
harness's window frames."""
from ..harness import program_trace
from ..harness.stats import percentile


def episodes(run):
    """[[records of the program's spans in each initialization frame] a
    window episode], or None where nothing can be read."""
    rec = program_trace.RECORDER
    log = getattr(run.feed, "init_log", None)
    if rec is None or not log:
        return None
    recs = [r for r in rec.records() if r.t1 is not None]
    by_fid = {}
    for r in recs:
        if r.frame >= 0:
            by_fid.setdefault(r.frame, []).append(r)
    frames = [r for r in recs if r.name == "frame"]
    out = []
    for ep in log:
        rs = []
        for t0, t1 in ep["frames"]:
            for f in frames:
                if t0 <= f.t0 * 1e-9 and f.t1 * 1e-9 <= t1:
                    rs.extend(by_fid.get(f.frame, [f]))
        out.append(rs)
    return out if any(out) else None


def read(run):
    eps = episodes(run)
    if eps is None:
        return None
    return 1e3 * percentile([sum(r.t1 - r.t0 for r in rs if r.name == "track.init") * 1e-9
                             for rs in eps], 50)
