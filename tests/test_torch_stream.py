"""The live frame-stream frontend of the port (hfnet_slam_torch/utils/stream.py)
against the JAX reference's (port on the CPU).

  * tests/test_stream.py's three tests on the port;
  * the same 25 image-keyed frames through a reference server on the
    reference system and a port server on the port system (sync): states
    equal frame by frame, tracked counts within 2, keyframe and map-point
    counts equal, ATE <= max(2 x reference, 0.01 m) (tests/test_torch_async.py's
    tolerances); every pose on the wire is the system's trajectory entry to
    the wire's 6 decimals;
  * a port client against a reference server and a reference client against
    a port server on the mono flow;
  * the port server's repairs, each on input the reference mishandles: one
    track_* in flight under two clients, an oversized header answered before
    any payload is read, a depth frame sent to a mono server raising in the
    client;
  * the step gate on the port system, and run_stream's --fake demo.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

STATES = {"NOT_INITIALIZED", "OK", "RECENTLY_LOST", "LOST"}


def _orbit_pose(i, radius=10.0, rate=0.02):
    """tests/test_stream.py's orbit."""
    target = np.array([0.0, 0.0, radius])
    th = rate * i
    c = np.array([radius * np.sin(th), 0.0, radius - radius * np.cos(th)])
    fwd = target - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0, 1, 0], fwd)
    right /= np.linalg.norm(right)
    R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
    R = R_wc.T.astype(np.float32)
    return R, (-R @ c).astype(np.float32)


class _ReplayExtractor:
    """Image-keyed fake: the frame index sits in the image's first pixel
    pair; features come from a pose-keyed FakeExtractor at that index's pose."""

    def __init__(self, ext):
        self.ext = ext

    def __call__(self, image):
        i = int(image[0, 0]) * 256 + int(image[0, 1])
        return self.ext(*_orbit_pose(i))


def _frame_image(i, h=48, w=64):
    img = np.zeros((h, w), np.uint8)
    img[0, 0], img[0, 1] = i // 256, i % 256
    return img


def _make_system(pkg="torch"):
    """tests/test_stream.py's system in package `pkg`."""
    if pkg == "tpu":
        from hfnet_slam_tpu.geometry import cameras
        from hfnet_slam_tpu.models.fake import FakeExtractor, SyntheticWorld
        from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
        kw = {}
    else:
        from hfnet_slam_torch.geometry import cameras
        from hfnet_slam_torch.models.fake import FakeExtractor, SyntheticWorld
        from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
        kw = {"device": "cpu"}
    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, **kw)
    world = SyntheticWorld.cloud(seed=5, n_landmarks=800, extent=16.0, center=(0, 0, 10.0),
                                 desc_dim=32)
    ext = FakeExtractor(world, cam, pad_to=256, noise_px=0.3, desc_noise=0.03,
                        max_landmarks_per_frame=256, seed=7, **kw)
    cfg = SystemConfig(k_max=32, m_max=4096, n_slots=256, desc_dim=32, gdesc_dim=32,
                       async_mapping=False, loop_closing=False)
    return SLAMSystem(cam, _ReplayExtractor(ext), cfg, **kw)


def _session(server_cls, client_cls, sysm, n=25):
    srv = server_cls(sysm)
    cli = client_cls(*srv.address)
    try:
        return [cli.send_image(_frame_image(i), 0.05 * i) for i in range(n)]
    finally:
        cli.close()
        srv.close()
        sysm.shutdown()


# ---------------------------------------------------------------------------
# tests/test_stream.py on the port
# ---------------------------------------------------------------------------
def test_mono_session_tracks_and_returns_poses():
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient

    sysm = _make_system()
    results = _session(SLAMStreamServer, StreamClient, sysm)
    assert {r["state"] for r in results} <= STATES
    tracked = [r for r in results if r["R"] is not None]
    assert len(tracked) >= 10
    R = np.asarray(tracked[-1]["R"])
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
    assert sysm.tracker.state == 1
    assert len(tracked[-1]["t"]) == 3
    # every pose on the wire is the system's trajectory entry, to 6 decimals
    traj = {round(e.ts, 9): e for e in sysm.tracker.trajectory}
    assert len(traj) == len(tracked)
    for r in tracked:
        e = traj[round(r["ts"], 9)]
        np.testing.assert_array_equal(np.asarray(r["R"]), np.round(e.R.astype(np.float64), 6))
        np.testing.assert_array_equal(np.asarray(r["t"]), np.round(e.t.astype(np.float64), 6))


def test_imu_rows_pass_through():
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient

    sysm = _make_system()
    seen = []

    def spy(img, ts, imu):
        seen.append(np.asarray(imu))
        return sysm.track_monocular(img, ts)

    sysm.track_monocular_inertial = spy
    srv = SLAMStreamServer(sysm)
    cli = StreamClient(*srv.address)
    try:
        imu = np.tile([0, 0, 9.81, 0, 0, 0, 0.005], (10, 1))
        r = cli.send_image(_frame_image(0), 0.0, imu=imu)
        assert r["state"] in ("NOT_INITIALIZED", "OK")
        assert len(seen) == 1 and seen[0].shape == (10, 7) and seen[0].dtype == np.float32
    finally:
        cli.close()
        srv.close()
        sysm.shutdown()


def test_rgbd_pairing_and_writable_frames():
    """An RGB-D pair reaches track_rgbd together; both arrays arrive
    writable (np.frombuffer over the received bytearray)."""
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient

    sysm = _make_system()
    calls = []
    sysm.track_rgbd = lambda img, d, ts: calls.append((img, d, ts)) or (0, None, None)
    srv = SLAMStreamServer(sysm)
    srv.set_rgbd(True)
    cli = StreamClient(*srv.address)
    try:
        depth = np.full((48, 64), 2.5, np.float32)
        r = cli.send_image(_frame_image(0), 0.1, depth=depth)
        assert r["state"] == "NOT_INITIALIZED" and r["R"] is None
        img, d, ts = calls[0]
        assert len(calls) == 1 and img.dtype == np.uint8 and d.dtype == np.float32
        assert ts == 0.1 and np.allclose(d, 2.5)
        assert img.flags.writeable and d.flags.writeable
        torch.as_tensor(img)  # no read-only warning path
    finally:
        cli.close()
        srv.close()
        sysm.shutdown()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def test_stream_session_matches_reference():
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_tpu.utils import stream as JS
    from hfnet_slam_torch.utils import stream as TS

    sys_j, sys_t = _make_system("tpu"), _make_system("torch")
    res_j = _session(JS.SLAMStreamServer, JS.StreamClient, sys_j)
    res_t = _session(TS.SLAMStreamServer, TS.StreamClient, sys_t)
    assert [r["state"] for r in res_t] == [r["state"] for r in res_j]
    tr_j = [i for i, r in enumerate(res_j) if r["R"] is not None]
    tr_t = [i for i, r in enumerate(res_t) if r["R"] is not None]
    assert abs(len(tr_t) - len(tr_j)) <= 2 and len(tr_t) >= 10
    assert int(sys_t.store.kf_valid.sum()) == int(sys_j.store.kf_valid.sum())
    assert int(sys_t.store.mp_valid.sum()) == int(sys_j.store.mp_valid.sum())

    def centres(res, ids):
        est = [-np.asarray(res[i]["R"]).T @ np.asarray(res[i]["t"]) for i in ids]
        gt = [-_orbit_pose(i)[0].T @ _orbit_pose(i)[1] for i in ids]
        return np.asarray(est), np.asarray(gt)

    e_j = ate.ate_rmse(*centres(res_j, tr_j), with_scale=True)
    e_t = ate.ate_rmse(*centres(res_t, tr_t), with_scale=True)
    assert e_t <= max(2 * e_j, 0.01), (e_t, e_j)


@pytest.mark.parametrize("server_pkg", ["tpu", "torch"])
def test_clients_and_servers_interoperate(server_pkg):
    """A port client against a reference server, and a reference client
    against a port server, on the mono flow: the same answers as a session
    within one package."""
    from hfnet_slam_tpu.utils import stream as JS
    from hfnet_slam_torch.utils import stream as TS

    srv_mod, cli_mod = (JS, TS) if server_pkg == "tpu" else (TS, JS)
    mixed = _session(srv_mod.SLAMStreamServer, cli_mod.StreamClient, _make_system(server_pkg),
                     n=12)
    same = _session(srv_mod.SLAMStreamServer, srv_mod.StreamClient, _make_system(server_pkg),
                    n=12)
    assert mixed == same
    assert sum(r["R"] is not None for r in mixed) >= 5


# ---------------------------------------------------------------------------
# the port server's repairs
# ---------------------------------------------------------------------------
class _SlowSystem:
    """Records how many track_* calls overlap."""

    def __init__(self):
        self.active = self.most = self.calls = 0
        self._lk = threading.Lock()

    def track_monocular(self, image, ts):
        with self._lk:
            self.active += 1
            self.calls += 1
            self.most = max(self.most, self.active)
        time.sleep(0.02)
        with self._lk:
            self.active -= 1
        return 0, None, None

    def shutdown(self):
        pass


def test_two_clients_never_overlap_in_the_tracker():
    """Two clients streaming at once: the server lets one track_* call run
    at a time (the reference's ThreadingTCPServer has no such lock)."""
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient

    sysm = _SlowSystem()
    srv = SLAMStreamServer(sysm)
    start = threading.Barrier(2)

    def client(k):
        cli = StreamClient(*srv.address)
        start.wait()
        for i in range(10):
            cli.send_image(_frame_image(i), 0.05 * i + k)
        cli.close()

    ths = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30)
    srv.close()
    assert sysm.calls == 20 and sysm.most == 1, (sysm.calls, sysm.most)


def _raw(srv, payload: bytes):
    """Send raw bytes; return the first answer line and whether the server
    then closed the connection."""
    s = socket.create_connection(srv.address, timeout=10)
    try:
        s.sendall(payload)
        f = s.makefile("rb")
        line = f.readline()
        closed = f.readline() == b""
        return json.loads(line), closed
    finally:
        s.close()


@pytest.mark.parametrize("head", [
    {"type": "image", "ts": 0.0, "h": 1_000_000_000, "w": 640, "dtype": "uint8"},
    {"type": "image", "ts": 0.0, "h": 0, "w": 640, "dtype": "uint8"},
    {"type": "image", "ts": 0.0, "h": 8192, "w": 8192, "dtype": "float64"},
])
def test_oversized_header_is_refused_before_its_payload(head):
    """A header with h or w outside 1..8192, or a payload over 256 MiB, is
    answered with one error line with no payload sent at all, and the
    connection closes. The reference would wait for (and allocate) it."""
    from hfnet_slam_torch.utils.stream import SLAMStreamServer

    sysm = _SlowSystem()
    srv = SLAMStreamServer(sysm)
    try:
        out, closed = _raw(srv, json.dumps(head).encode() + b"\n")
        assert "error" in out and closed and sysm.calls == 0
    finally:
        srv.close()


def test_depth_frame_to_a_mono_server_raises_in_the_client():
    """The port's client marks an image whose depth half follows; a mono port
    server answers it with an error in place of a result and the client
    raises. A reference client (no mark) still gets the mono result of the
    image, as from the reference's server."""
    from hfnet_slam_tpu.utils import stream as JS
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient, StreamError

    sysm = _make_system()
    srv = SLAMStreamServer(sysm)
    depth = np.full((48, 64), 2.5, np.float32)
    try:
        cli = StreamClient(*srv.address)
        with pytest.raises(StreamError, match="RGB-D"):
            cli.send_image(_frame_image(0), 0.0, depth=depth)
        cli.close()
        assert len(sysm.tracker.trajectory) == 0 and sysm.tracker.state == 0
        ref_cli = JS.StreamClient(*srv.address)
        r = ref_cli.send_image(_frame_image(0), 0.0, depth=depth)
        assert r["state"] == "NOT_INITIALIZED" and "error" not in r
        ref_cli.close()
    finally:
        srv.close()
        sysm.shutdown()


# ---------------------------------------------------------------------------
# the step gate and the demo
# ---------------------------------------------------------------------------
def test_step_gate_holds_track_features_until_a_step():
    from hfnet_slam_torch.utils.viewer import LiveViewer

    sysm = _make_system()
    feats = sysm.extractor(_frame_image(0))
    lv = LiveViewer(out_path=None, every_kf=1000)
    sysm.viewer = lv
    lv.set_step_by_step(True)
    done = []
    th = threading.Thread(target=lambda: done.append(sysm.track_features(feats, 0.0)),
                          daemon=True)
    th.start()
    time.sleep(0.3)
    assert done == [] and lv.frames == 1  # held at the gate
    lv.step()
    th.join(timeout=10)
    assert len(done) == 1 and done[0][0] == 0  # a first monocular frame: NOT_INITIALIZED
    sysm.shutdown()


def test_run_stream_fake_demo_on_the_cpu():
    from hfnet_slam_torch.examples import run_stream

    out = run_stream.main(["--fake", "--frames", "20", "--port", "0", "--device", "cpu"])
    assert out["frames"] == 20 and out["tracked"] >= 10, out
    assert out["final_state"] == "OK"
