"""The port's viewers (hfnet_slam_torch/utils/viewer.py, webviewer.py)
against the JAX reference's (port on the CPU).

  * tests/test_webviewer.py's two tests and tests/test_utils.py's
    LiveViewer test on the port;
  * `_snapshot`'s JSON equal to the reference's on a map carried over with
    convert.store_from_reference and the same trajectory;
  * `render`'s plotted data equal to the reference's: scatter offsets and
    line vertices;
  * `/control` refuses a cross-origin POST (403) and takes a same-origin
    one or one without Origin.
"""
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)


def _mk_store(cls):
    """tests/test_webviewer.py's store in either package."""
    rng = np.random.default_rng(0)
    store = cls(k_max=8, m_max=128, n_slots=16, desc_dim=8, gdesc_dim=8)
    store.add_points(rng.uniform(-2, 2, (40, 3)), rng.standard_normal((40, 8)))
    for k in range(3):
        store.kf_valid[k] = True
        store.kf_t[k] = [0.2 * k, 0, 0]
        store.n_kf += 1
    store.kf_parent[1] = 0
    store.kf_parent[2] = 1
    store.loop_edges.append((0, 2))
    return store


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _post(url, payload, origin=None, timeout=5):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    if origin is not None:
        req.add_header("Origin", origin)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def test_page_state_and_controls():
    from hfnet_slam_torch.slam.map import MapStore
    from hfnet_slam_torch.utils.webviewer import WebViewer

    store = _mk_store(MapStore)
    wv = WebViewer(port=0, every_kf=1, min_period=0.0)
    try:
        wv.on_frame(store, None)
        code, page = _get(wv.url)
        assert code == 200 and b"hfnet-slam-torch" in page
        code, body = _get(wv.url + "state.json")
        st = json.loads(body)
        assert code == 200
        assert st["n_kf"] == 3 and st["n_mp"] == 40
        assert len(st["kf"]) == 3 and len(st["mp"]) == 40
        assert st["tree"] == [[1, 0], [2, 1]]
        assert st["loops"] == [[0, 2]]
        assert st["frames"] == 1

        _post(wv.url + "control", {"cmd": "step_mode", "on": True})
        passed = []

        def run():
            for _ in range(2):
                wv.on_frame(store, None)
                passed.append(1)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        time.sleep(0.15)
        assert passed == []
        _post(wv.url + "control", {"cmd": "step", "n": 1})
        for _ in range(50):
            if len(passed) == 1:
                break
            time.sleep(0.02)
        assert len(passed) == 1
        _post(wv.url + "control", {"cmd": "release"})
        th.join(timeout=5)
        assert len(passed) == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(wv.url + "nope")
        assert e.value.code == 404
    finally:
        wv.close()


def test_system_hook_and_tracker_fields():
    """start_webviewer attaches the viewer as the system's frame hook; it
    publishes the tracker's state and trajectory; shutdown closes it."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    world = SyntheticWorld.cloud(seed=5, n_landmarks=600, extent=16.0, center=(0, 0, 10.0),
                                 desc_dim=32)
    ext = FakeExtractor(world, cam, pad_to=256, noise_px=0.3, desc_noise=0.03,
                        max_landmarks_per_frame=240, seed=7, device="cpu")
    cfg = SystemConfig(k_max=32, m_max=4096, n_slots=256, desc_dim=32, gdesc_dim=32,
                       async_mapping=False, loop_closing=False)
    sysm = SLAMSystem(cam, ext, cfg, device="cpu")
    wv = sysm.start_webviewer(min_period=0.0)
    try:
        target = np.array([0.0, 0.0, 10.0])
        for i in range(10):
            th = 0.02 * i
            c = np.array([10 * np.sin(th), 0.0, 10 - 10 * np.cos(th)])
            fwd = (target - c) / np.linalg.norm(target - c)
            right = np.cross([0, 1, 0], fwd)
            right /= np.linalg.norm(right)
            R = np.stack([right, np.cross(fwd, right), fwd], 1).T.astype(np.float32)
            sysm.track_features(ext(R, (-R @ c).astype(np.float32)), 0.05 * i)
        st = json.loads(_get(wv.url + "state.json")[1])
        assert st["frames"] == 10
        assert st["state"] in ("NOT_INITIALIZED", "OK", "LOST", "RECENTLY_LOST")
        assert st["traj"] and st["cam"] is not None and len(st["cam"]) == 3
    finally:
        sysm.shutdown()
        assert not wv._thread.is_alive()


def test_live_viewer_stepping_and_render(tmp_path):
    """tests/test_utils.py's LiveViewer test on the port."""
    from hfnet_slam_torch.slam.map import MapStore
    from hfnet_slam_torch.utils.viewer import LiveViewer

    store = MapStore(k_max=8, m_max=64, n_slots=16, desc_dim=8, gdesc_dim=8)
    lv = LiveViewer(out_path=str(tmp_path / "live.png"), every_kf=2)
    lv.set_step_by_step(True)
    passed = []

    def run():
        for _ in range(3):
            lv.on_frame(store, None)
            passed.append(1)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    time.sleep(0.2)
    assert passed == []
    lv.step(2)
    for _ in range(50):
        if len(passed) == 2:
            break
        time.sleep(0.05)
    assert len(passed) == 2
    lv.release()
    th.join(timeout=5)
    assert len(passed) == 3

    lv2 = LiveViewer(out_path=str(tmp_path / "live2.png"), every_kf=2)
    lv2.on_frame(store, None)
    assert lv2.renders == 0
    store.kf_valid[:2] = True
    lv2.on_frame(store, None)
    assert lv2.renders == 1 and (tmp_path / "live2.png").exists()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's SMALL browse after 40 frames (a map with keyframes,
    a spanning tree and points), both packages' stores of its snapshot (a
    loop edge added to each), and its trajectory as (ts, R, t) tuples."""
    from _torch_parity import browse_pose, build
    from hfnet_slam_tpu.slam.map import MapStore as JMapStore
    from hfnet_slam_torch import convert

    ref, ext = build("tpu")
    for i in range(40):
        ref.track_features(ext(*browse_pose(i)), 0.05 * i)
    path = os.path.join(tmp_path_factory.mktemp("viewer"), "map.npz")
    ref.save_map(path)
    js, ts = JMapStore.load(path), convert.store_from_reference(path)
    kfs = js.valid_kf_ids()
    assert len(kfs) >= 3
    for s in (js, ts):
        s.loop_edges.append((int(kfs[0]), int(kfs[-1])))
    traj = [(float(s), np.asarray(R), np.asarray(t)) for s, R, t in ref.tracker.trajectory]
    return js, ts, traj, int(ref.tracker.state)


def test_snapshot_json_matches_reference(carried):
    from hfnet_slam_tpu.utils import webviewer as JW
    from hfnet_slam_torch.utils import webviewer as TW

    js, ts, traj, state = carried
    tracker = types.SimpleNamespace(state=state, trajectory=traj)
    a = json.dumps(JW._snapshot(js, tracker, max_points=300))
    b = json.dumps(TW._snapshot(ts, tracker, max_points=300))
    assert b == a
    snap = json.loads(b)
    assert snap["n_kf"] >= 3 and snap["tree"] and snap["loops"] and snap["traj"]
    assert json.dumps(TW._snapshot(ts, None)) == json.dumps(JW._snapshot(js, None))


def test_render_plots_the_reference_data(carried):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from hfnet_slam_tpu.utils import viewer as JV
    from hfnet_slam_torch.utils import viewer as TV

    js, ts, traj, _ = carried

    def plotted(fig):
        ax = fig.axes[0]
        pts = [np.asarray(c._offsets3d) for c in ax.collections]
        lines = [np.asarray(ln.get_data_3d()) for ln in ax.lines]
        return pts, lines

    fj, ft = JV.render(js, traj, max_points=300), TV.render(ts, traj, max_points=300)
    (pj, lj), (pt, lt) = plotted(fj), plotted(ft)
    plt.close(fj)
    plt.close(ft)
    assert len(pt) == len(pj) == 2 and len(lt) == len(lj) >= 3
    for a, b in zip(pt + lt, pj + lj):
        np.testing.assert_array_equal(a, b)


def test_control_refuses_a_cross_origin_post():
    from hfnet_slam_torch.utils.webviewer import WebViewer

    wv = WebViewer(port=0, min_period=0.0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(wv.url + "control", {"cmd": "step_mode", "on": True},
                  origin="http://evil.example")
        assert e.value.code == 403 and not wv._step_mode
        assert _post(wv.url + "control", {"cmd": "step_mode", "on": True},
                     origin=wv.origin)[0] == 200
        assert wv._step_mode
        assert _post(wv.url + "control", {"cmd": "step_mode", "on": False})[0] == 200
        assert not wv._step_mode
    finally:
        wv.close()
