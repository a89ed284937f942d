"""Run configuration: the reference's YAML settings files.

Counterpart of hfnet_slam_tpu/utils/settings.py (the reference's Settings
class): one versioned file per run (`File.version: "1.0"`) with flat dotted
keys for the camera calibration, the extractor and the system. The reference
strips the cv::FileStorage dialect and hands the text to PyYAML; the port
reads the same files with its own parser of the subset those files use, so
it needs no YAML package:
  * the `%YAML:1.0` header and `#` comments;
  * top-level `key: value` lines whose value is a scalar (typed as YAML
    1.1 types plain scalars: int, float, bool, null, else a string), a
    quoted string or a flow list `[...]`, which may run over several lines;
  * `!!opencv-matrix` blocks of indented `rows`, `cols`, `dt` and `data`.
Anything else (nested mappings, block sequences, anchors, other tags) raises
ValueError naming the line.

`Settings.make_camera()`, `make_camera_right()`, `make_imu_calib()` and
`make_system_config()` turn a Settings into the port's cameras, IMU
calibration and SystemConfig; the sensor (`monocular`, `stereo`, `rgbd` and
their `imu-` variants) is recorded as given.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

import numpy as np

SENSOR_MONOCULAR = "monocular"
SENSOR_STEREO = "stereo"
SENSOR_RGBD = "rgbd"
SENSOR_IMU_MONOCULAR = "imu-monocular"
SENSOR_IMU_STEREO = "imu-stereo"

_KEY = re.compile(r"^([A-Za-z_][\w.]*)\s*:(?:\s+(.*))?$")
# YAML 1.1's implicit types, as PyYAML's safe loader resolves plain scalars
# (a float needs a dot: 7e-3 stays a string, as there)
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_INT = re.compile(r"^[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_SPECIAL = {**{s + x: float(s + "inf") for s in ("", "+", "-") for x in (".inf", ".Inf", ".INF")},
            **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan"))}
_MATRIX_KEYS = ("rows", "cols", "dt", "data")


def _yaml_int(tok: str) -> int:
    t = tok.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t[0] == "0":
        return sign * int(t, 8)
    return sign * int(t)


def _strip_comment(line: str) -> str:
    """The line without a `#` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _scalar(tok: str, where: str):
    """One plain or quoted scalar, typed as YAML 1.1 types it."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        if tok[0] == '"':
            return ast.literal_eval(tok)
        return tok[1:-1].replace("''", "'")
    if not tok or tok in ("~", "null", "Null", "NULL"):
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return _yaml_int(tok)
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if tok in _SPECIAL:
        return _SPECIAL[tok]
    if tok[0] in "[]{}&*!|>%@`" or ": " in tok or tok.endswith(":"):
        raise ValueError(f"settings: unsupported YAML value {tok!r} at {where}")
    return tok


def _flow_list(text: str, where: str):
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"settings: malformed flow list at {where}")
    body = body[1:-1].strip()
    if not body:
        return []
    if "[" in body or "{" in body:
        raise ValueError(f"settings: nested flow collections are unsupported at {where}")
    items = [x.strip() for x in body.split(",")]
    if items[-1] == "":  # a trailing comma
        items = items[:-1]
    return [_scalar(x, where) for x in items]


def parse_opencv_yaml(text: str) -> dict:
    """The top-level mapping of a cv::FileStorage YAML file (the subset in
    the module docstring)."""
    lines = [_strip_comment(ln).rstrip() for ln in text.splitlines()]
    out: dict = {}
    i = 0
    if lines and re.match(r"^%YAML[:\s][\d.]+\s*$", lines[0]):
        i = 1

    def take_flow(first: str, start: int):
        """A flow list starting on line `start` with text `first`, continued
        on the following lines until its `]`. Returns (list, next line)."""
        buf, j = first, start + 1
        while buf.count("[") > buf.count("]"):
            if j >= len(lines):
                raise ValueError(f"settings: unterminated list from line {start + 1}")
            buf += " " + lines[j].strip()
            j += 1
        return _flow_list(buf, f"line {start + 1}"), j

    while i < len(lines):
        line = lines[i]
        where = f"line {i + 1}"
        if not line.strip():
            i += 1
            continue
        if line[0].isspace():
            raise ValueError(f"settings: unexpected indented line at {where}: {line.strip()!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"settings: not a 'key: value' line at {where}: {line!r}")
        key, val = m.group(1), (m.group(2) or "").strip()
        if key in out:
            raise ValueError(f"settings: duplicate key {key!r} at {where}")
        if val == "!!opencv-matrix":
            mat, j = {}, i + 1
            while j < len(lines) and (not lines[j].strip() or lines[j][0].isspace()):
                sub = lines[j].strip()
                if not sub:
                    j += 1
                    continue
                mm = _KEY.match(sub)
                if mm is None or mm.group(1) not in _MATRIX_KEYS or mm.group(1) in mat:
                    raise ValueError(f"settings: bad opencv-matrix entry at line {j + 1}: "
                                     f"{sub!r}")
                name, sv = mm.group(1), (mm.group(2) or "").strip()
                if name == "data":
                    mat[name], j = take_flow(sv, j)
                else:
                    mat[name] = _scalar(sv, f"line {j + 1}")
                    j += 1
            if set(mat) != set(_MATRIX_KEYS):
                raise ValueError(f"settings: opencv-matrix {key!r} needs rows, cols, dt and "
                                 f"data ({where})")
            out[key] = mat
            i = j
        elif val.startswith("["):
            out[key], i = take_flow(val, i)
        elif val == "":
            if i + 1 < len(lines) and lines[i + 1][:1].isspace() and lines[i + 1].strip():
                raise ValueError(f"settings: nested mappings are unsupported ({key!r}, {where})")
            out[key] = None
            i += 1
        else:
            out[key] = _scalar(val, where)
            i += 1
    return out


def load_yaml(path) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read())


def depth_multiplier(path) -> Optional[float]:
    """HF-Net's width from a settings file's optional key
    `Extractor.depthMultiplier`, None without it. Read apart from `Settings`,
    whose fields are the reference's."""
    d = load_yaml(path)
    return float(d["Extractor.depthMultiplier"]) if "Extractor.depthMultiplier" in d else None


def make_hfnet(depth_multiplier=None, weights=None, device=None):
    """The runners' HF-Net on `device` (None means CUDA): the .npz `weights`
    at `depth_multiplier` (None: the file's own width; a file of another
    width raises), or without weights He-initialized from seed 0 at that
    width (1.0 for None)."""
    import torch

    from .. import device as D
    from ..models import hfnet

    dev = D.resolve(device)
    if weights:
        return hfnet.load_params(weights, device=dev, depth_multiplier=depth_multiplier)
    m = 1.0 if depth_multiplier is None else depth_multiplier
    return hfnet.HFNet(torch.Generator(device=dev).manual_seed(0), m)


def _mat(node) -> Optional[np.ndarray]:
    """Decode an opencv-matrix node {rows, cols, dt, data}."""
    if node is None:
        return None
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(int(node["rows"]), int(node["cols"]))
    return np.asarray(node, np.float64)


@dataclasses.dataclass
class Settings:
    """Typed view of one settings file (Settings.h's getters), field for
    field the reference's."""

    camera_type: str = "PinHole"      # PinHole | Rectified | KannalaBrandt8
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    dist: tuple = ()                  # k1 k2 p1 p2 [k3] or KB8 k1-k4
    width: int = 0
    height: int = 0
    new_width: int = 0                # optional resize (Camera.newWidth)
    new_height: int = 0
    fps: float = 30.0
    rgb: bool = True
    baseline: float = 0.0             # Stereo.b
    th_depth: float = 35.0            # Stereo.ThDepth (in baseline units)
    cam2: tuple = ()                  # (fx, fy, cx, cy) or empty
    dist2: tuple = ()
    T_c1_c2: Optional[np.ndarray] = None
    depth_map_factor: float = 1.0
    T_b_c: Optional[np.ndarray] = None
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    imu_frequency: float = 200.0
    extractor_type: str = "HFNetTPU"
    model_path: str = ""
    n_features: int = 1000
    n_levels: int = 4
    scale_factor: float = 1.2
    threshold: float = 0.01
    loop_closing: bool = True
    load_atlas: str = ""
    save_atlas: str = ""
    th_far_points: float = 0.0

    @staticmethod
    def from_yaml(path, sensor: str = SENSOR_MONOCULAR) -> "Settings":
        d = load_yaml(path)
        version = str(d.get("File.version", ""))
        if version not in ("1.0", ""):
            raise ValueError(f"unsupported settings version {version!r}")

        def g(key, default=None):
            return d.get(key, default)

        dist_keys = ["Camera1.k1", "Camera1.k2", "Camera1.p1", "Camera1.p2",
                     "Camera1.k3", "Camera1.k4"]
        s = Settings(
            camera_type=str(g("Camera.type", "PinHole")),
            fx=float(g("Camera1.fx", 0.0)), fy=float(g("Camera1.fy", 0.0)),
            cx=float(g("Camera1.cx", 0.0)), cy=float(g("Camera1.cy", 0.0)),
            dist=tuple(float(d[k]) for k in dist_keys if k in d),
            width=int(g("Camera.width", 0)), height=int(g("Camera.height", 0)),
            new_width=int(g("Camera.newWidth", 0) or 0),
            new_height=int(g("Camera.newHeight", 0) or 0),
            fps=float(g("Camera.fps", 30.0)),
            rgb=bool(g("Camera.RGB", 1)),
            baseline=float(g("Stereo.b", 0.0) or 0.0),
            th_depth=float(g("Stereo.ThDepth", 35.0) or 35.0),
            cam2=(tuple(float(d[k]) for k in ("Camera2.fx", "Camera2.fy", "Camera2.cx",
                                               "Camera2.cy"))
                  if "Camera2.fx" in d else ()),
            dist2=tuple(float(d[k]) for k in ("Camera2.k1", "Camera2.k2", "Camera2.p1",
                                               "Camera2.p2", "Camera2.k3", "Camera2.k4")
                        if k in d),
            T_c1_c2=_mat(g("Stereo.T_c1_c2")),
            depth_map_factor=float(g("RGBD.DepthMapFactor", 1.0) or 1.0),
            T_b_c=_mat(g("IMU.T_b_c1")),
            noise_gyro=float(g("IMU.NoiseGyro", 1.7e-4) or 1.7e-4),
            noise_acc=float(g("IMU.NoiseAcc", 2.0e-3) or 2.0e-3),
            gyro_walk=float(g("IMU.GyroWalk", 1.9e-5) or 1.9e-5),
            acc_walk=float(g("IMU.AccWalk", 3.0e-3) or 3.0e-3),
            imu_frequency=float(g("IMU.Frequency", 200.0) or 200.0),
            extractor_type=str(g("Extractor.type", "HFNetTPU")),
            model_path=str(g("Extractor.modelPath", "")),
            n_features=int(g("Extractor.nFeatures", 1000)),
            n_levels=int(g("Extractor.nLevels", 4)),
            scale_factor=float(g("Extractor.scaleFactor", 1.2)),
            threshold=float(g("Extractor.threshold", 0.01)),
            loop_closing=bool(g("loopClosing", 1)),
            load_atlas=str(g("System.LoadAtlasFromFile", "") or ""),
            save_atlas=str(g("System.SaveAtlasToFile", "") or ""),
            th_far_points=float(g("System.thFarPoints", 0.0) or 0.0),
        )
        s.sensor = sensor
        return s

    # ------------------------------------------------------------------
    def make_camera(self, device=None):
        """The geometry camera on `device` (None means CUDA). A distorted
        PinHole rig carries its radial-tangential coefficients, and the
        system undistorts keypoints once a frame; `Rectified` images were
        undistorted upstream."""
        from ..geometry import cameras

        w = self.new_width or self.width
        h = self.new_height or self.height
        sx = w / self.width if self.width else 1.0
        sy = h / self.height if self.height else 1.0
        if self.camera_type in ("PinHole", "Rectified"):
            dist = self.dist if (self.camera_type == "PinHole" and any(self.dist)) else None
            return cameras.pinhole(self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy,
                                   w, h, dist=dist, device=device)
        if self.camera_type == "KannalaBrandt8":
            k = (list(self.dist) + [0.0] * 4)[:4]
            return cameras.kb8(self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy, *k,
                               w, h, device=device)
        raise ValueError(f"unknown camera type {self.camera_type}")

    def make_camera_right(self, device=None):
        """The second camera of an unrectified stereo rig (Camera2.*) on
        `device`, or None: with Stereo.T_c1_c2 it drives the fisheye stereo
        matcher and the right bank."""
        if not self.cam2:
            return None
        from ..geometry import cameras

        w = self.new_width or self.width
        h = self.new_height or self.height
        sx = w / self.width if self.width else 1.0
        sy = h / self.height if self.height else 1.0
        fx, fy, cx, cy = self.cam2
        if self.camera_type == "KannalaBrandt8":
            k = (list(self.dist2) + [0.0] * 4)[:4]
            return cameras.kb8(fx * sx, fy * sy, cx * sx, cy * sy, *k, w, h, device=device)
        dist = self.dist2 if any(self.dist2) else None
        return cameras.pinhole(fx * sx, fy * sy, cx * sx, cy * sy, w, h, dist=dist,
                               device=device)

    def make_imu_calib(self):
        """The IMU calibration of the IMU.* keys: noise densities in discrete
        form (multiplied or divided by sqrt(IMU.Frequency)) and IMU.T_b_c1,
        the camera-to-body extrinsic."""
        from ..geometry import imu

        sf = float(np.sqrt(self.imu_frequency))
        Tbc = np.asarray(self.T_b_c if self.T_b_c is not None else np.eye(4), np.float32)
        return imu.ImuCalib(sigma_g=float(np.float32(self.noise_gyro * sf)),
                            sigma_a=float(np.float32(self.noise_acc * sf)),
                            sigma_gw=float(np.float32(self.gyro_walk / sf)),
                            sigma_aw=float(np.float32(self.acc_walk / sf)),
                            Tbc_R=Tbc[:3, :3].copy(), Tbc_t=Tbc[:3, 3].copy())

    def make_system_config(self, device=None, **overrides):
        """The SystemConfig the settings describe, with `overrides` set on
        it (e.g. async_mapping=True). An unrectified rig (Camera2 and
        Stereo.T_c1_c2) gets its right camera on `device` and the
        right-in-left extrinsic, and the baseline |t_c1_c2| when Stereo.b
        is absent."""
        from ..slam.system import SystemConfig

        cfg = SystemConfig(
            loop_closing=self.loop_closing,
            baseline=self.baseline,
            depth_factor=(1.0 / self.depth_map_factor if self.depth_map_factor > 1.0 else 1.0))
        cfg.tracker.th_depth = (self.th_depth * self.baseline if self.baseline > 0
                                else self.th_depth)
        cfg.tracker.th_far = self.th_far_points
        # keyframe cadence: the reference sets mMaxFrames = fps, at most ~1 s
        # between keyframes
        if self.fps > 0:
            cfg.tracker.max_frames_between_kf = int(round(self.fps))
        if self.cam2 and self.T_c1_c2 is not None:
            cfg.cam_right = self.make_camera_right(device)
            T = np.asarray(self.T_c1_c2, np.float64)
            cfg.T_lr = (T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32))
            if cfg.baseline <= 0:
                cfg.baseline = float(np.linalg.norm(T[:3, 3]))
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
