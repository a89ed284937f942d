"""The port's async pipeline workers and the repairs its threads need, on the
CPU: ports of the reference's worker tests (tests/test_stress.py,
tests/test_gba.py), the loop worker's backlog collapse, drain() raising a
worker's exception again, the GBA worker's supersede keeping the stop
sentinel, the device map mirror under concurrent syncs, the `_t` helpers
returning copies rather than views of the store, and the kernel's launch
counters under 8 threads."""
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import cams  # noqa: E402
from hfnet_slam_torch.slam import pipeline as PL  # noqa: E402


class _Store:
    kf_valid = np.ones(64, bool)


def _fake_system(**parts):
    sys_ = types.SimpleNamespace(store=_Store(), loop_closer=None, loop_worker=None,
                                 mapper=types.SimpleNamespace(abort_ba=False),
                                 tracker=types.SimpleNamespace(velocity=None))
    for k, v in parts.items():
        setattr(sys_, k, v)
    return sys_


# ---------------------------------------------------------------------------
# tests/test_stress.py
# ---------------------------------------------------------------------------

def test_mapping_pause_handshake_no_toctou():
    """request_pause() never reports 'paused' while the worker is about to
    start an item: a keyframe-less fake system whose process hook records
    whether it ever ran while a pause was granted."""
    overlap = [False]
    paused_granted = threading.Event()

    class FakeMapper:
        abort_ba = False

        def process_keyframe(self, k, do_ba=True):
            time.sleep(0.002)
            overlap[0] |= paused_granted.is_set()

    sys_ = _fake_system(mapper=FakeMapper())
    w = PL.MappingWorker(sys_)
    try:
        for trial in range(60):
            w.enqueue(sys_.store, trial % 64)
            w.request_pause(timeout=5.0)  # race the pause against the pick-up
            paused_granted.set()
            time.sleep(0.004)  # the worker would start the item now if racy
            paused_granted.clear()
            w.resume()
        w.drain()
    finally:
        w.stop()
    assert not overlap[0], "worker processed a keyframe while request_pause had returned"
    assert w.processed == 60


def _make_store(m=2048, k=8, n=128, d=32):
    from hfnet_slam_torch.slam.map import MapStore

    rng = np.random.default_rng(0)
    store = MapStore(k_max=k, m_max=m, n_slots=n, desc_dim=d, gdesc_dim=d)
    pos = rng.uniform(-5, 5, (m // 2, 3)).astype(np.float32)
    pos[:, 2] += 10.0
    desc = rng.standard_normal((m // 2, d)).astype(np.float32)
    store.add_points(pos, desc / np.linalg.norm(desc, axis=1, keepdims=True))
    return store


def test_sync_vs_fuse_hammer():
    """A thread marking rows dirty and syncing the shared mirror in a tight
    loop (what the tracker does every frame) while the main thread takes a
    snapshot under the lock and runs the fuse on it off the lock (what the
    loop-correction fuse does): no error, and the fuse reads a consistent
    snapshot every time."""
    from hfnet_slam_torch.slam import fused

    cam = cams()[1]
    store = _make_store()
    lock = threading.RLock()
    dm = fused.get_device_map(store, "cpu")
    rng = np.random.default_rng(1)
    stop, errs = threading.Event(), []

    def tracker_loop():
        try:
            r = np.random.default_rng(2)
            while not stop.is_set():
                with lock:
                    ids = r.integers(0, store.m_max // 2, 64)
                    store.mp_pos[ids] += np.float32(0.01)
                    store.mark_points_dirty(ids)
                    dm.sync()
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    th = threading.Thread(target=tracker_loop, daemon=True)
    th.start()
    P, N, C = 4, store.n_slots, 256
    R_t = torch.eye(3).expand(P, 3, 3).contiguous()
    t_t = torch.zeros(P, 3)
    xy_t = torch.from_numpy(rng.uniform(0, 128, (P, N, 2)).astype(np.float32))
    desc_t = torch.from_numpy(rng.standard_normal((P, N, store.desc_dim)).astype(np.float32))
    desc_t = desc_t / desc_t.norm(dim=2, keepdim=True)
    oct_t = torch.zeros(P, N, dtype=torch.int32)
    free_t = torch.ones(P, N, dtype=torch.bool)
    cand = torch.from_numpy(rng.integers(0, store.m_max // 2, (P, C)))
    deadline, n_runs = time.monotonic() + 2.0, 0
    try:
        while time.monotonic() < deadline:
            with lock:
                dm.sync()
                pos_s, desc_s, _, _, _, valid_s = dm.snapshot()
                want = pos_s.clone()
            idx = fused._fuse_core(cam.kind, cam.params, 128.0, 128.0, R_t, t_t, xy_t, desc_t,
                                   oct_t, free_t, cand, pos_s, desc_s, valid_s, 3.0, 0.6)
            assert idx.shape == (P, N)
            assert torch.equal(pos_s, want)  # nobody wrote into the snapshot
            n_runs += 1
    finally:
        stop.set()
        th.join(timeout=10)
    assert not errs, f"tracker thread raised: {errs[0]!r}"
    assert n_runs >= 3


def test_snapshot_survives_concurrent_syncs():
    """A captured snapshot keeps its values after later syncs moved the live
    mirror (sync replaces tables, never writes into them)."""
    from hfnet_slam_torch.slam import fused

    store = _make_store()
    dm = fused.get_device_map(store, "cpu")
    dm.sync()
    pos0, *_, valid0 = dm.snapshot()
    before = pos0.clone()
    for _ in range(8):
        store.mp_pos[: store.m_max // 2] += 0.5
        store.mark_points_dirty(np.arange(store.m_max // 2))
        dm.sync()
    assert not torch.allclose(dm.pos, before)
    assert torch.equal(pos0, before)
    assert not np.shares_memory(pos0.numpy(), store.mp_pos)
    assert valid0.shape == (store.m_max,)


# ---------------------------------------------------------------------------
# tests/test_gba.py's worker tests, on the reference's circle_store
# ---------------------------------------------------------------------------

def test_detached_gba_worker_abort_and_supersede(tmp_path):
    """A new request aborts or supersedes the one in flight (mbStopGBA); the
    final map state comes from a completed solve, which improves it."""
    from test_gba import _pose_err, circle_store
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig

    store_j, _, gt_R, gt_t = circle_store(K=60, P=500, obs_per_kf=25, seed=2)
    anchors = [0, 20, 40]
    for a in anchors:
        store_j.kf_R[a] = gt_R[a]
        store_j.kf_t[a] = gt_t[a]
    path = str(tmp_path / "ring.npz")
    store_j.save(path)
    store = store_from_reference(path)
    w = PL.GBAWorker(LocalMapper(cams()[1], store, MapperConfig(), device="cpu"))
    try:
        kf_ids = store.valid_kf_ids()
        before = _pose_err(store, gt_R, gt_t, kf_ids).mean()
        w.request("visual", fixed_ids=anchors, rounds=((60, True),))  # long, superseded
        time.sleep(0.02)
        w.request("visual", fixed_ids=anchors, rounds=((10, True), (8, False)))
        w.drain()
        assert w.full_ba_idx == 1 and w.aborted <= 1
        after = _pose_err(store, gt_R, gt_t, kf_ids).mean()
        assert after < before / 3
        assert np.isfinite(store.kf_t[kf_ids]).all()
        assert store.big_change_idx == 1  # only the completed solve wrote back
    finally:
        w.stop()
    # 'inertial' is FullInertialBA on the mapper's VIManager, abortable as well
    calls = []

    class Mapper:
        vim = object()

        def full_inertial_ba(self, vim, should_abort=None, **kw):
            calls.append((vim, should_abort is not None, kw))

    w = PL.GBAWorker(Mapper())
    try:
        w.request("inertial", rounds=((3, True), (4, False)))
        w.drain()
        assert calls == [(Mapper.vim, True, {"rounds": ((3, True), (4, False))})]
        assert w.full_ba_idx == 1
        with pytest.raises(ValueError, match="unknown kind"):
            w.request("stereo")
    finally:
        w.stop()


def test_stale_local_ba_discarded_after_big_change(tmp_path):
    """A BA built before a whole-map move (big_change_idx bump) does not
    write back its stale poses."""
    from test_gba import circle_store
    from hfnet_slam_torch.convert import store_from_reference
    from hfnet_slam_torch.slam.local_mapping import LocalMapper, MapperConfig

    store_j, _, _, _ = circle_store(K=30, P=300, obs_per_kf=25, seed=4)
    path = str(tmp_path / "ring.npz")
    store_j.save(path)
    store = store_from_reference(path)
    mapper = LocalMapper(cams()[1], store, MapperConfig(), device="cpu")
    kf_ids = store.valid_kf_ids()
    snapshot = store.kf_t.copy()
    bumped = []

    def abort_probe():  # a loop correction lands mid-solve
        if not bumped:
            store.kf_t[kf_ids] += 0.5
            store.bump_change()
            bumped.append(1)
        return False

    res = mapper._run_ba(list(kf_ids), fixed_ids={0, 1}, rounds=((2, True), (2, True)),
                         should_abort=abort_probe)
    assert res is None, "a stale solve must be discarded"
    np.testing.assert_allclose(store.kf_t[kf_ids], snapshot[kf_ids] + 0.5)


# ---------------------------------------------------------------------------
# the workers' queue protocol
# ---------------------------------------------------------------------------

def test_loop_worker_collapses_its_backlog_to_the_newest_keyframe():
    """Keyframes queued while a detection runs are skipped but for the
    newest one; every queued item is accounted for by drain()."""
    seen, gate, started = [], threading.Event(), threading.Event()

    class Closer:
        def process_keyframe(self, k):
            seen.append(k)
            started.set()
            gate.wait(10)
            return False

    sys_ = _fake_system(loop_closer=Closer(),
                        worker=types.SimpleNamespace(map_lock=threading.RLock()))
    w = PL.LoopWorker(sys_)
    try:
        w.enqueue(sys_.store, 0)
        assert started.wait(10)
        for k in (1, 2, 3):
            w.enqueue(sys_.store, k)
        gate.set()
        w.drain()
    finally:
        w.stop()
    assert seen == [0, 3]
    assert w.processed == 2 and w.skipped == 2


@pytest.mark.parametrize("which", ["mapping", "loop", "gba"])
def test_drain_raises_a_worker_exception_again(which):
    """A worker's exception is kept and raised by the next drain(), once; the
    worker goes on serving its queue."""
    calls = []

    def boom(*a, **kw):
        calls.append(a)
        if len(calls) == 1:
            raise ValueError(f"{which} failed")
        return False

    if which == "mapping":
        w = PL.MappingWorker(_fake_system(mapper=types.SimpleNamespace(
            abort_ba=False, process_keyframe=boom)))
        submit = lambda: w.enqueue(w.system.store, 1)  # noqa: E731
    elif which == "loop":
        w = PL.LoopWorker(_fake_system(
            loop_closer=types.SimpleNamespace(process_keyframe=boom),
            worker=types.SimpleNamespace(map_lock=threading.RLock())))
        submit = lambda: w.enqueue(w.system.store, 1)  # noqa: E731
    else:
        w = PL.GBAWorker(types.SimpleNamespace(run_global_ba=boom))
        submit = lambda: w.request("visual", fixed_ids=[0])  # noqa: E731
    try:
        submit()
        with pytest.raises(ValueError, match=f"{which} failed"):
            w.drain()
        w.drain()  # raised once
        submit()
        w.drain()
        assert len(calls) == 2
    finally:
        w.stop()
    assert not w._thread.is_alive()


def test_gba_supersede_keeps_the_stop_sentinel():
    """A request that supersedes a queued solve behind which stop() already
    queued its sentinel puts the sentinel back: the thread still ends, after
    the newest solve."""
    ran, gate = [], threading.Event()

    def solve(should_abort, tag):
        ran.append(tag)
        if tag == "a":
            gate.wait(10)

    w = PL.GBAWorker(types.SimpleNamespace(run_global_ba=solve))
    w.request("visual", tag="a")
    while not ran:
        time.sleep(0.001)
    w.request("visual", tag="b")  # aborts a, queued behind it
    w.q.put(None)                 # stop()'s sentinel, queued behind b
    w.request("visual", tag="c")  # supersedes b; must not eat the sentinel
    gate.set()
    w._thread.join(timeout=10)
    assert not w._thread.is_alive(), "the stop sentinel was lost"
    assert ran == ["a", "c"]
    assert w.aborted == 1 and w.full_ba_idx == 1


# ---------------------------------------------------------------------------
# fault 1: host arrays reach the device as copies, never as store views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("owner", ["tracker", "mapper", "loop_closer", "retrieval"])
def test_store_arrays_reach_torch_as_copies(owner, monkeypatch):
    """On the CPU torch.as_tensor shares memory with numpy: work run off the
    map lock would read what another thread writes. Every helper that turns
    store arrays into tensors copies them."""
    from hfnet_slam_torch.ops import matching as TM
    from hfnet_slam_torch.slam import retrieval
    from hfnet_slam_torch.slam.local_mapping import LocalMapper
    from hfnet_slam_torch.slam.loop_closing import LoopCloser
    from hfnet_slam_torch.slam.map import MapStore
    from hfnet_slam_torch.slam.tracking import Tracker

    cam = cams()[1]
    store = MapStore(8, 64, 16, 8, 8)
    store.kf_valid[:3] = True
    store.kf_gdesc[:3] = np.eye(3, 8, dtype=np.float32)
    arrays = {"kf_R": store.kf_R, "kf_desc": store.kf_desc, "kf_valid": store.kf_valid,
              "kf_gdesc": store.kf_gdesc, "mp_pos": store.mp_pos}
    got = {}
    if owner == "retrieval":
        real = TM.global_scores

        def spy(q, g, v):
            got.update(kf_gdesc=g, kf_valid=v)
            return real(q, g, v)

        monkeypatch.setattr(TM, "global_scores", spy)
        retrieval.score_all(store, np.ones(8, np.float32), device="cpu")
    else:
        obj = {"tracker": lambda: Tracker(cam, store, device="cpu"),
               "mapper": lambda: LocalMapper(cam, store, device="cpu"),
               "loop_closer": lambda: LoopCloser(cam, store, device="cpu")}[owner]()
        for name in ("kf_R", "kf_desc", "mp_pos"):
            got[name] = obj._t(arrays[name])
        got["kf_valid"] = obj._t(arrays["kf_valid"], torch.bool)
    assert len(got) >= 2
    for name, t in got.items():
        a = arrays[name]
        np.testing.assert_array_equal(t.numpy(), a)
        assert not np.shares_memory(t.numpy(), a), name
        lo = a.__array_interface__["data"][0]
        assert not (lo <= t.data_ptr() < lo + a.nbytes), name


# ---------------------------------------------------------------------------
# fault 2: the kernel's launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_counters_count_every_launch_from_8_threads(monkeypatch):
    """8 threads go through the wrapper's launch path (bf_match._launch) with
    a stub kernel library, 300 launches each: every launch is counted, in all,
    by shape and by thread."""
    from hfnet_slam_torch.ops import bf_match as B

    class StubLib:
        def row_top2_nsplit(self, NA, NB, n_sm):
            return 2

        def row_top2_scratch_words(self, NA, nsplit):
            return 16

        def row_top2_launch(self, *args):
            return 0

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(B, "_plans", {})
    B.reset_counts()
    lib, n_threads, n_calls = StubLib(), 8, 300
    A, Bm, m = torch.zeros(16, 8), torch.zeros(24, 8), torch.ones(24, dtype=torch.bool)
    errs = []

    def run():
        try:
            for _ in range(n_calls):
                B._launch(lib, A, Bm, m, stream=0)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    ths = [threading.Thread(target=run, name=f"counter-{i}") for i in range(n_threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert not errs, errs
    assert B.launches == n_threads * n_calls
    assert B.shape_launches[(16, 24, 8)] == n_threads * n_calls
    for i in range(n_threads):
        assert B.thread_shape_launches[(f"counter-{i}", 16, 24, 8)] == n_calls
    assert len(B._plans) == 1  # one plan per (device, stream, shape)
    B.reset_counts()
    assert B.launches == 0 and not B.shape_launches and not B.thread_shape_launches
