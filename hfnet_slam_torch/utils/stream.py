"""Live frame-stream frontend: the reference's ROS nodes (ros_mono,
ros_rgbd, ros_mono_inertial) as a plain TCP socket protocol. Any producer
(camera driver, simulator, ROS bridge, another process) connects and
streams frames; each tracked frame's result streams back on the same
connection. The wire format is the JAX package's, byte for byte, so a
client of either package talks to a server of either package.

Wire format (one message = one JSON header line + raw payload bytes):

    {"type":"image","ts":3.21,"h":480,"w":752,"dtype":"uint8",
     "depth":false,"imu":[[ax,ay,az,wx,wy,wz,dt],...]}\\n
    <h*w*itemsize little-endian bytes>                     (row-major)

- grayscale image frames: dtype uint8 or float32;
- RGB-D: send `"depth":true` with a float32 depth payload immediately after
  its image frame (same ts); the pair is tracked together;
- mono-inertial: attach `imu` rows [ax ay az wx wy wz dt] covering
  (t_prev, t] to the image header;
- `{"type":"end"}\\n` finishes the session.

Each tracked frame answers with one JSON line

    {"ts":3.21,"state":"OK","R":[[...]x3],"t":[x,y,z]}\\n

(the camera pose T_cw, R and t rounded to 6 decimals; null while not
tracked). A fault is answered with one `{"error": ...}` line, after which
the server closes the connection.

Three behaviours differ from the JAX package's server, each only on input
that it mishandles:
- one lock serializes every call into the system: a second client's frames
  wait, and never run inside the tracker beside the first client's;
- a header whose h or w lies outside 1..MAX_SIDE, or whose payload exceeds
  MAX_PAYLOAD bytes, is answered with an error before any payload is read;
- an image header may say `"depth_follows": true` (this package's client
  says so when it sends a depth half). A server not in RGB-D mode answers
  such an image with an error in place of its result, reads and drops the
  depth half, and closes; the client raises on the error. Without the key
  the frame goes as in the JAX package.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading

import numpy as np

MAX_SIDE = 8192
MAX_PAYLOAD = 256 << 20


class StreamError(RuntimeError):
    """The server answered with an error line."""


def _read_exact(rfile, n: int) -> bytearray:
    buf = bytearray()
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-payload")
        buf += chunk
    return buf


def _read_message(rfile):
    """One header line + payload. Returns (header dict, ndarray or None).
    The array is writable (np.frombuffer over the bytearray read)."""
    line = rfile.readline()
    if not line:
        return None, None
    head = json.loads(line)
    if head.get("type") == "end":
        return head, None
    h, w = int(head["h"]), int(head["w"])
    dt = np.dtype(head.get("dtype", "uint8")).newbyteorder("<")
    if not (1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE):
        raise ValueError(f"frame {h}x{w} outside 1..{MAX_SIDE}")
    if h * w * dt.itemsize > MAX_PAYLOAD:
        raise ValueError(f"payload of {h * w * dt.itemsize} bytes over {MAX_PAYLOAD}")
    payload = _read_exact(rfile, h * w * dt.itemsize)
    return head, np.frombuffer(payload, dt).reshape(h, w)


def _error_line(msg: str) -> bytes:
    return json.dumps({"error": msg[:200]}).encode() + b"\n"


class SLAMStreamServer:
    """Serve a SLAMSystem over a socket (ros_mono / ros_rgbd /
    ros_mono_inertial in one). Connections are handled on threads of their
    own, and tracking runs on the handler thread; `lock` serializes the
    calls into the system, so one frame is in the tracker at a time."""

    def __init__(self, system, host="127.0.0.1", port=0):
        self.system = system
        self.lock = threading.Lock()
        self._rgbd = False
        srv_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                pending = None  # image waiting for its depth pair
                while True:
                    try:
                        head, arr = _read_message(self.rfile)
                    except (ConnectionError, json.JSONDecodeError, KeyError, TypeError,
                            ValueError) as e:
                        self.wfile.write(_error_line(f"{type(e).__name__}: {e}"))
                        return
                    if head is None or head.get("type") == "end":
                        return
                    ts = float(head.get("ts", 0.0))
                    if head.get("depth"):
                        if pending is None or pending[0] != ts:
                            self.wfile.write(b'{"error":"depth frame without matching '
                                             b'image"}\n')
                            return
                        img = pending[1]
                        pending = None
                        with srv_self.lock:
                            st, R, t = srv_self.system.track_rgbd(
                                img, arr.astype(np.float32), ts)
                    elif srv_self._rgbd:
                        pending = (ts, arr)
                        continue  # wait for the depth half of the pair
                    elif head.get("depth_follows"):
                        self.wfile.write(_error_line(
                            "depth frame sent to a server not in RGB-D mode"))
                        self.wfile.flush()
                        try:  # drop the depth half so the client is not reset
                            _read_message(self.rfile)
                        except (ConnectionError, json.JSONDecodeError, KeyError,
                                TypeError, ValueError):
                            pass
                        return
                    else:
                        imu = head.get("imu")
                        with srv_self.lock:
                            if imu:
                                st, R, t = srv_self.system.track_monocular_inertial(
                                    arr, ts, np.asarray(imu, np.float32))
                            else:
                                st, R, t = srv_self.system.track_monocular(arr, ts)
                    self.wfile.write(srv_self._result_line(ts, st, R, t))
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="hfnet-stream", daemon=True)
        self._thread.start()

    def set_rgbd(self, flag: bool = True):
        """Declare the session RGB-D: image frames wait for their depth
        half (ros_rgbd's synchronized image + depth callback)."""
        self._rgbd = bool(flag)

    @staticmethod
    def _result_line(ts, st, R, t) -> bytes:
        from ..slam.tracking import _STATE_NAMES

        out = {"ts": ts, "state": _STATE_NAMES.get(st, str(st)),
               "R": None if R is None else np.round(np.asarray(R, np.float64), 6).tolist(),
               "t": None if t is None else np.round(np.asarray(t, np.float64), 6).tolist()}
        return json.dumps(out).encode() + b"\n"

    @property
    def address(self):
        return self._server.server_address[:2]

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class StreamClient:
    """The producer's side (what a camera driver or a ROS bridge embeds):
    connect, push frames, read tracking results."""

    def __init__(self, host, port, timeout=30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")

    def send_image(self, image, ts, imu=None, depth=None):
        """Send one frame (with optional IMU rows and a float32 depth map);
        returns the server's result dict for it. Raises StreamError when the
        server answers with an error."""
        img = np.ascontiguousarray(image)
        head = {"type": "image", "ts": float(ts), "h": img.shape[0], "w": img.shape[1],
                "dtype": img.dtype.name}
        if imu is not None:
            head["imu"] = np.asarray(imu, np.float64).tolist()
        if depth is not None:
            head["depth_follows"] = True
        msg = json.dumps(head).encode() + b"\n" + img.astype(
            img.dtype.newbyteorder("<"), copy=False).tobytes()
        if depth is not None:
            d = np.ascontiguousarray(depth, np.float32)
            dhead = {"type": "image", "ts": float(ts), "h": d.shape[0], "w": d.shape[1],
                     "dtype": "float32", "depth": True}
            msg += json.dumps(dhead).encode() + b"\n" + d.astype("<f4", copy=False).tobytes()
        self._sock.sendall(msg)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the stream")
        out = json.loads(line)
        if "error" in out:
            raise StreamError(out["error"])
        return out

    def close(self):
        try:
            self._sock.sendall(b'{"type":"end"}\n')
        except OSError:
            pass
        self._rfile.close()
        self._sock.close()
