"""The program's own spans and counters (hfnet_slam_torch/utils/timing.py,
the port's recorder) in a traced run.

Importing this module switches the program's recorder on. The readers of
the per-layer metrics that read the program's spans import it, and
harness/core.run loads those readers only in `--trace 1` runs, before
set-up: so the recorder is on in exactly the traced runs, and the untraced
runs that give the end-to-end metrics run with it off. A program without
the recorder (no `enable`) leaves every reading here None.

Which frames count: the program's `frame` spans that lie inside one of the
harness's window frames (Run.window_frames: the host clock's [t0, t1] around
each call into the program in the measured window; time.perf_counter and
the recorder's perf_counter_ns read one clock), so the set-up's frames do
not. Every span that carries a counted frame's id belongs to it, the
mapping worker's too.

The shared clock: the recorder's anchor maps its perf_counter_ns times onto
the unix-epoch clock of the profiler's events (Trace.kernels), so each idle
stretch of the card lines up with the span the host was in, without marker
kernels, in every traced slice. An idle stretch is a gap between two
consecutive device activities of one slice.
"""
from __future__ import annotations

from .stats import percentile

try:
    from hfnet_slam_torch.utils.timing import timings as _timings
except ImportError:   # no program to read
    _timings = None
RECORDER = _timings if all(hasattr(_timings, a) for a in ("enable", "records", "anchor")) \
    else None
if RECORDER is not None:
    RECORDER.reset()
    RECORDER.enable()


def frame_groups(run):
    """[(frame record, [records carrying its id])] of the counted frames,
    or None where nothing can be read."""
    rec = RECORDER
    window = sorted(getattr(run, "window_frames", None) or [])
    if rec is None or not window:
        return None
    recs = [r for r in rec.records() if r.t1 is not None]
    by_fid = {}
    for r in recs:
        if r.frame >= 0:
            by_fid.setdefault(r.frame, []).append(r)
    out, j = [], 0
    for f in sorted((r for r in recs if r.name == "frame"), key=lambda r: r.t0):
        a, b = f.t0 * 1e-9, f.t1 * 1e-9
        while j < len(window) and window[j][1] < a:
            j += 1
        if j < len(window) and window[j][0] <= a and b <= window[j][1]:
            out.append((f, by_fid.get(f.frame, [f])))
    return out or None


def per_frame(run, names=None, counter=None):
    """Each counted frame's sum of the durations (s) of its spans named in
    `names`, or of its spans' `counter`; None where nothing can be read."""
    groups = frame_groups(run)
    if groups is None:
        return None
    out = []
    for _, rs in groups:
        if counter is not None:
            out.append(sum((r.counts or {}).get(counter, 0) for r in rs))
        else:
            out.append(sum(r.t1 - r.t0 for r in rs if r.name in names) * 1e-9)
    return out


def span_median_ms(run, name):
    """Median host ms of the program's spans named `name` in the counted
    frames, one a span; None where there is none."""
    groups = frame_groups(run)
    if groups is None:
        return None
    v = [(r.t1 - r.t0) * 1e-9 for _, rs in groups for r in rs if r.name == name]
    return 1e3 * percentile(v, 50) if v else None


def median_ms(run, names):
    v = per_frame(run, names=names)
    return None if v is None else 1e3 * percentile(v, 50)


def median_count(run, counter, scale=1.0):
    v = per_frame(run, counter=counter)
    return None if v is None else scale * percentile(v, 50)


def idle_gaps(trace):
    """[(start, end)] ns of the card's idle stretches: gaps between
    consecutive device activities inside one traced slice."""
    gaps, end = [], None
    for _, s, e in trace.kernels:
        if end is not None and s > end and s not in trace.cuts:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def innermost_segments(spans):
    """Disjoint (start, end, record) stretches of nested (start, end, record)
    spans, each labelled with the innermost span open in it."""
    segs, stack, cur = [], [], None
    for a, b, r in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            top = stack.pop()
            if top[1] > cur:
                segs.append((cur, top[1], top[2]))
            cur = top[1]
        if stack and a > cur:
            segs.append((cur, a, stack[-1][2]))
        stack.append((a, b, r))
        cur = a
    while stack:
        top = stack.pop()
        if top[1] > cur:
            segs.append((cur, top[1], top[2]))
        cur = max(cur, top[1])
    return segs


def idle_by_span(run):
    """(idle ns by the innermost span open on the frames' thread when the
    card was idle, keyed by record, with None for none; total idle ns), over
    every traced slice; None where nothing can be read."""
    rec = RECORDER
    groups = frame_groups(run)
    tr = run.trace
    if groups is None or tr is None or not tr.kernels or rec.anchor is None:
        return None
    threads = {f.thread for f, _ in groups}
    p0, u0 = rec.anchor
    spans = [(r.t0 - p0 + u0, r.t1 - p0 + u0, r) for r in rec.records()
             if r.t1 is not None and r.thread in threads]
    segs = innermost_segments(spans)
    by, total, i = {}, 0, 0
    for g0, g1 in idle_gaps(tr):
        total += g1 - g0
        covered = 0
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        k = i
        while k < len(segs) and segs[k][0] < g1:
            ov = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if ov > 0:
                by[segs[k][2]] = by.get(segs[k][2], 0) + ov
                covered += ov
            k += 1
        if g1 - g0 > covered:
            by[None] = by.get(None, 0) + (g1 - g0 - covered)
    return by, total


def idle_named_pct(run):
    """Share (%) of the card's idle time in the traced slices during which
    the host's innermost open program span on the frames' thread lay below
    a `frame` span."""
    got = idle_by_span(run)
    if got is None or got[1] <= 0:
        return None
    by, total = got
    named = sum(v for r, v in by.items() if r is not None and r.frame >= 0 and r.name != "frame")
    return 100.0 * named / total
