"""The readers of the program's own spans and counters
(harness/program_trace.py and the metrics on it) against hand arithmetic,
on a synthetic run: two window frames and a warm-up frame of the program's
recorder, the harness's window frames (and the extract spans that counted
frames before), and a device trace of two slices."""
import types

import pytest

from hfnet_slam_torch.utils.timing import SpanRecord
from slambench.harness import program_trace as PT
from slambench.harness.trace import Trace
from slambench.metrics import (device_wait_ms, extract_host_ms, h2d_kb_frame, idle_named_pct,
                               step_host_ms, syncs_frame)

MS = 1_000_000
U0 = 1_700_000_000 * 10**9   # the unix ns of perf_counter_ns 0


def _frame(recs, fid, t, step_ms, readback_ms, prepare_bytes, thread=1):
    """frame [t, t+100] ms: extract (a forward inside), frame.upload,
    frame.readback, track (prepare, step, readback), then 5 ms of the
    frame's own."""
    def add(name, a, b, parent, counts=None):
        r = SpanRecord(name, parent, fid, thread, len(recs))
        r.t0, r.t1, r.counts = (t + a) * MS, (t + b) * MS, counts
        recs.append(r)
        return r.idx

    f = add("frame", 0, 100, -1)
    e = add("extract", 0, 30, f)
    add("extract.forward", 0, 20, e)
    add("frame.upload", 30, 32, f, {"h2d_bytes": 4096})
    add("frame.readback", 32, 40, f, {"syncs": 1})
    tr = add("track", 40, 95, f)
    add("track.prepare", 41, 45, tr, {"h2d_bytes": prepare_bytes, "syncs": 2})
    add("track.step", 45, 45 + step_ms, tr)
    add("track.readback", 45 + step_ms, 45 + step_ms + readback_ms, tr, {"syncs": 6})


@pytest.fixture
def run(monkeypatch):
    recs = []
    _frame(recs, 7, -500, 100, 1, 10**6)      # warm-up: no harness extract span
    _frame(recs, 8, 0, 15, 20, 1024)
    _frame(recs, 9, 200, 5, 40, 3072)
    rec = types.SimpleNamespace(records=lambda: list(recs), anchor=(0, U0))
    monkeypatch.setattr(PT, "RECORDER", rec)
    spans = types.SimpleNamespace(spans={"extract": [(0.0005, 0.0295, None),
                                                     (0.2005, 0.2295, None)]})
    window = [(-0.0002, 0.1003), (0.1998, 0.3001)]   # around each call into the program
    tr = Trace()
    ks = [(0, 20), (45, 55), (90, 98), (210, 220), (296, 310), (330, 340)]
    tr.kernels = [("k", U0 + a * MS, U0 + b * MS) for a, b in ks]
    tr.cuts = {U0 + 210 * MS}   # the second slice's first activity
    return types.SimpleNamespace(spans=spans, trace=tr, window_frames=window)


def test_counted_frames_are_the_windows(run):
    groups = PT.frame_groups(run)
    assert [f.frame for f, _ in groups] == [8, 9] and all(len(rs) == 9 for _, rs in groups)


def test_span_and_counter_medians_by_hand(run):
    assert extract_host_ms.read(run) == pytest.approx(30.0)
    assert step_host_ms.read(run) == pytest.approx((15 + 5) / 2)
    assert device_wait_ms.read(run) == pytest.approx(((8 + 20) + (8 + 40)) / 2)
    assert h2d_kb_frame.read(run) == pytest.approx(((4096 + 1024) + (4096 + 3072)) / 2 / 1024)
    assert syncs_frame.read(run) == pytest.approx(9.0)


def test_idle_named_share_by_hand(run):
    """Idle gaps: 20-45 ms (extract's own, upload, readback, track, prepare:
    all named), 55-90 (step, readback, track's own: named), the cross-slice
    98-210 (not a gap), 220-296 (75 ms named, 1 ms of frame 9's own time),
    310-330 (between frames): 135 of 156 ms named."""
    assert PT.idle_gaps(run.trace) == [(U0 + a * MS, U0 + b * MS)
                                       for a, b in ((20, 45), (55, 90), (220, 296), (310, 330))]
    by, total = PT.idle_by_span(run)
    assert total == 156 * MS and by[None] == 20 * MS
    named = {}
    for r, v in by.items():
        if r is not None:
            named[r.name] = named.get(r.name, 0) + v
    assert named["frame"] == 1 * MS and named["track.readback"] == 20 * MS + 40 * MS
    assert idle_named_pct.read(run) == pytest.approx(100.0 * 135 / 156)


def test_innermost_segments():
    a, b, c = "abc"
    segs = PT.innermost_segments([(0, 10, a), (2, 4, b), (4, 6, c), (12, 13, b)])
    assert segs == [(0, 2, a), (2, 4, b), (4, 6, c), (6, 10, a), (12, 13, b)]


def test_nothing_to_read_reads_none(run, monkeypatch):
    """A program without the recorder, or a run with no harness spans."""
    assert PT.frame_groups(types.SimpleNamespace(spans=None, trace=None)) is None
    monkeypatch.setattr(PT, "RECORDER", None)
    for m in (extract_host_ms, step_host_ms, device_wait_ms, h2d_kb_frame, syncs_frame,
              idle_named_pct):
        assert m.read(run) is None
