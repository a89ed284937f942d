"""The port's recorder (hfnet_slam_torch/utils/timing.py) on the CPU: off it
records nothing, on it gives a tracked frame's span tree, charges counters
to the innermost span, carries a frame's id onto the mapping worker, maps
its clock onto the profiler's, reports self times, counts uploads through
device.upload and syncs issued by the port only."""
import os
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hfnet_slam_torch import device as D  # noqa: E402
from hfnet_slam_torch.utils import timing as T  # noqa: E402
from hfnet_slam_torch.utils.timing import timings  # noqa: E402

FUSED = ("frame", [("frame.upload", []), ("frame.readback", []),
                   ("track", [("track.lock", []), ("track.map_sync", []), ("track.prepare", []),
                              ("track.step", []), ("track.readback", []), ("track.update", []),
                              ("track.local_set", []), ("track.kf_decision", [])])])
MAPPING = ("mapping", [("mapping.cull_points", []), ("mapping.triangulate", []),
                       ("mapping.fuse", []), ("mapping.distinctive", []),
                       ("mapping.local_ba", [("ba.build", []), ("ba.solve", []),
                                             ("ba.readback", []), ("ba.writeback", [])]),
                       ("mapping.cull_kfs", [])])


@pytest.fixture
def recorder():
    timings.reset()
    yield timings
    timings.disable()
    timings.reset()


def _tree(recs, root):
    kids = [r for r in recs if r.parent == root.idx]
    return (root.name, [_tree(recs, k) for k in kids])


def _rgbd(n, keyframe_at=None, async_mapping=False):
    """An RGB-D SMALL system on the CPU tracking n browse frames, with a
    keyframe forced at frame `keyframe_at`."""
    from hfnet_slam_torch.scenes import SMALL, browse_pose, depth_image, rgbd_system

    sys_, ext = rgbd_system(SMALL, "cpu", async_mapping=async_mapping)
    need = sys_.tracker._need_new_keyframe
    for i in range(n):
        sys_.tracker._need_new_keyframe = (lambda f: True) if i == keyframe_at else need
        R, t = browse_pose(i)
        sys_.track_rgbd((R, t), depth_image(ext.world, ext.cam, R, t, i), 0.05 * i)
    sys_.tracker._need_new_keyframe = need
    return sys_


def test_off_records_nothing_and_allocates_no_span(recorder):
    assert not timings.on
    assert timings.span("a") is timings.span("b") is T.NULL_SPAN
    assert timings.frame() is T.NULL_SPAN and timings.frame_scope(3) is T.NULL_SPAN
    sys_ = _rgbd(3)
    sys_.shutdown()
    timings.count("h2d_bytes", 10)
    assert timings.records() == [] and timings.stats() == {}
    assert timings.frame_id() == -1


def test_span_tree_of_tracked_frames(recorder):
    """A fused frame and a keyframe frame: the names and nesting of the
    frame path's spans, in order; mapping runs below track.keyframe in the
    synchronous pipeline."""
    timings.enable()
    sys_ = _rgbd(5, keyframe_at=4)
    sys_.shutdown()
    recs = timings.records()
    frames = [r for r in recs if r.name == "frame"]
    assert len(frames) == 5 and [f.frame for f in frames] == sorted({f.frame for f in frames})
    assert _tree(recs, frames[0]) == ("frame", [("frame.upload", []), ("frame.readback", []),
                                                ("track", [("track.lock", []),
                                                           ("track.init", [])])])
    assert _tree(recs, frames[2]) == FUSED
    name, kids = _tree(recs, frames[4])
    assert (name, kids[:2]) == FUSED[0:1] + (FUSED[1][:2],)
    track = kids[2]
    assert track[1][:-1] == FUSED[1][2][1] and track[1][-1] == ("track.keyframe", [MAPPING])
    for f in frames:  # every span below a frame carries its id
        below = [r for r in recs if r.t0 >= f.t0 and r.t1 <= f.t1]
        assert {r.frame for r in below} == {f.frame}
    n, mean, _, p50, _ = timings.stats()["track.step"]
    assert n == 4 and 0 < p50 and timings.self_stats()["track.step"] == pytest.approx(mean)
    rep = timings.report()
    assert rep.splitlines()[0].split()[-1] == "self" and "mapping.local_ba" in rep
    counters = rep[rep.index("counter"):].splitlines()[1:]
    h2d = sum((r.counts or {}).get("h2d_bytes", 0) for r in recs)
    assert [ln.split()[0] for ln in counters] == ["h2d_bytes", "mirror_rows"]
    assert counters[0].split()[1:] == [str(h2d), f"{h2d / 5:.1f}"]


def test_counters_are_charged_to_the_innermost_span(recorder):
    timings.enable()
    with timings.frame():
        timings.count("x", 2)
        with timings.span("a"):
            timings.count("x", 3)
            with timings.span("b"):
                timings.count("x")
                timings.count("y", 5)
            timings.count("x", 4)
    timings.count("x", 7)  # no span open: nowhere to go
    frame, a, b = timings.records()
    assert frame.counts == {"x": 2} and a.counts == {"x": 7} and b.counts == {"x": 1, "y": 5}
    assert (a.parent, b.parent) == (frame.idx, a.idx)
    # the depth upload and the step's inputs are charged to their spans
    sys_ = _rgbd(3)
    recs = timings.records()[3:]
    up = [r for r in recs if r.name == "frame.upload"]
    assert [r.counts["h2d_bytes"] for r in up] == [4 * 480 * 640] * 3
    assert all(r.counts["h2d_bytes"] > 0 for r in recs if r.name == "track.prepare")
    assert all(not r.counts for r in recs if r.name in ("track.step", "frame"))
    sync = [r for r in recs if r.name == "track.map_sync"]
    assert all("mirror_rows" in (r.counts or {}) for r in sync[:1])
    sys_.shutdown()


def test_async_mapping_spans_carry_the_frame_id_of_their_keyframe(recorder):
    timings.enable()
    sys_ = _rgbd(4, keyframe_at=3, async_mapping=True)
    sys_.finish()
    sys_.shutdown()
    recs = timings.records()
    kf = [r for r in recs if r.name == "track.keyframe"]
    maps = [r for r in recs if r.name == "mapping"]
    assert len(kf) == 1 and len(maps) == 1
    m = maps[0]
    assert m.frame == kf[0].frame >= 0 and m.parent == -1 and m.thread != kf[0].thread
    assert _tree(recs, m) == MAPPING
    assert all(r.frame == m.frame for r in recs if r.t0 >= m.t0 and r.t1 <= m.t1
               and r.thread == m.thread)


def test_anchor_maps_perf_counter_onto_the_profilers_clock(recorder):
    from torch.profiler import ProfilerActivity, profile, record_function

    timings.enable()
    p, u = timings.anchor
    assert abs(timings.to_unix_ns(time.perf_counter_ns()) - time.time_ns()) < 2_000_000
    assert timings.to_unix_ns(p) == u
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timings.span("host") as rec:
            with record_function("inside"):
                time.sleep(0.01)
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert len(ev) == 1
    a, b = timings.to_unix_ns(rec.t0), timings.to_unix_ns(rec.t1)
    # host events of the profiler lie on the unix-epoch clock
    assert a - 2_000_000 <= ev[0].start_ns() and \
        ev[0].start_ns() + ev[0].duration_ns() <= b + 2_000_000


def test_report_gives_each_names_self_time(recorder, tmp_path):
    timings.enable()
    for _ in range(2):
        with timings.span("outer"):
            time.sleep(0.002)
            with timings.span("inner"):
                time.sleep(0.001)
            with timings.span("inner"):
                time.sleep(0.001)
    timings.add("by_hand", 0.004)
    recs = timings.records()
    outer = [r for r in recs if r.name == "outer"]
    want = np.mean([(o.t1 - o.t0) - sum(r.t1 - r.t0 for r in recs if r.parent == o.idx)
                    for o in outer]) * 1e-6
    st = timings.self_stats()
    assert st["outer"] == pytest.approx(want, rel=1e-12) and st["by_hand"] == pytest.approx(4.0)
    assert st["inner"] == pytest.approx(timings.stats()["inner"][1])
    assert want > 1.5 and timings.stats()["outer"][1] >= want + 2.0
    row = [ln for ln in timings.report().splitlines() if ln.startswith("outer")][0]
    assert float(row.split()[-1]) == pytest.approx(want, abs=0.006)
    timings.save(str(tmp_path / "r.txt"))
    assert (tmp_path / "r.txt").read_text().strip() == timings.report()


def test_upload_copies_and_counts_bytes_only_while_on(recorder):
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    with timings.span("off"):
        t = D.upload(a, torch.float32, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    assert timings.records() == []
    i = np.arange(5, dtype=np.int32)
    u = D.upload(i, None, "cpu")
    assert u.dtype == torch.int32 and not np.shares_memory(u.numpy(), i)
    timings.enable()
    with timings.span("on") as rec:
        D.upload(a, torch.float32, "cpu")
        D.upload(i, torch.int64, "cpu")
    assert rec.counts == {"h2d_bytes": 12 * 4 + 5 * 8}
    timings.disable()
    with timings.span("off again"):
        D.upload(a, None, "cpu")
    assert len(timings.records()) == 1


def _probe(path):
    """A function whose warning comes from a line in file `path`."""
    ns = {}
    src = ("import warnings\n"
           "def probe(text):\n"
           "    warnings.warn(text)\n")
    exec(compile(src, path, "exec"), ns)
    return ns["probe"]


def test_sync_warnings_count_only_from_the_port(recorder):
    """torch's sync debug warnings (set to "warn" on a card) count one sync
    where the port's code issued them; other warnings pass through."""
    port = _probe(os.path.join(os.path.dirname(T.__file__), "_probe.py"))
    other = _probe(__file__)
    msg = "called a synchronizing CUDA operation"
    timings.enable()
    with timings.span("s") as rec:
        port(msg)
        port(msg)
        other(msg)
        with pytest.warns(UserWarning, match="something else"):
            port("something else")
    assert rec.counts == {"syncs": 2}
    timings.disable()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        port(msg)
    assert len(seen) == 1 and rec.counts == {"syncs": 2}


def test_extractor_spans_each_level(recorder):
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.models.hfnet import HFNet

    ext = HFExtractor(HFNet(torch.Generator().manual_seed(1)), (64, 96), n_features=60,
                      n_levels=2, pad_to=64, device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (64, 96), dtype=np.uint8)
    timings.enable()
    f = ext(img)
    recs = timings.records()
    assert _tree(recs, recs[0]) == ("extract", [("extract.forward", []), ("extract.post", [])] * 2)
    assert recs[0].counts == {"h2d_bytes": 64 * 96} and f.xy.shape == (64, 2)
