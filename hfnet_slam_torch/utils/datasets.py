"""Dataset readers: EuRoC, TUM-VI and TUM-RGBD sequences, and a PNG codec.

Counterpart of hfnet_slam_tpu/utils/datasets.py (the reference's LoadImages /
LoadIMU helpers and evaluation/associate.py): `load_euroc` reads an ASL
`mav0` directory (image timestamps in nanoseconds, IMU rows reordered to
`[t ax ay az wx wy wz]`), `Sequence.imu_between` cuts the per-frame IMU
blocks, `associate` pairs two timestamped lists, `load_tum_rgbd` /
`load_tum_vi` read the TUM layouts.

Images decode with `read_png`, built on zlib: 8-bit grayscale or RGB and
16-bit grayscale (big-endian samples, the depth maps of TUM-RGBD), not
interlaced, any of the five row filters; any other PNG raises ValueError.
RGB turns grayscale with the ITU-R 601-2 luma weights in the same integer
arithmetic as PIL's convert("L"). `write_png` writes 8-bit grayscale or RGB
and 16-bit grayscale (filter 0), as the synthetic sequences use it.
`Sequence.depth(i)` is depth image i divided by the sequence's depth_factor,
as the reference's reader returns it.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth_row(raw: bytes, prior, bpp: int) -> bytearray:
    """Reverse the Paeth filter of one row (sequential in x)."""
    out = bytearray(len(raw))
    for i in range(len(raw)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (raw[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior, bpp: int) -> bytearray:
    out = bytearray(len(raw))
    for i in range(len(raw)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (raw[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def read_png(path) -> np.ndarray:
    """(H, W) or (H, W, 3) uint8 of an 8-bit grayscale or RGB PNG; (H, W)
    uint16 of a 16-bit grayscale one."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are unsupported")
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    if ((depth, color) not in ((8, 0), (8, 2), (16, 0)) or comp != 0 or filt != 0
            or interlace != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color type {color}, "
                         f"interlace {interlace}); 8-bit grayscale or RGB and 16-bit "
                         "grayscale, not interlaced, are supported")
    bpp = 2 if depth == 16 else (1 if color == 0 else 3)  # bytes per pixel
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, want {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype == 3:  # Average
            cur = np.frombuffer(_average_row(line.tobytes(), prior.tolist(), bpp), np.uint8)
        elif ftype == 4:  # Paeth
            cur = np.frombuffer(_paeth_row(line.tobytes(), prior.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = cur
        prior = out[y]
    if depth == 16:
        return out.view(">u2").reshape(h, w).astype(np.uint16)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, 3)


def write_png(path, img) -> None:
    """Write an (H, W) or (H, W, 3) uint8 image as an 8-bit PNG, or an (H, W)
    uint16 one as a 16-bit grayscale PNG (filter 0)."""
    img = np.ascontiguousarray(img)
    wide = img.dtype == np.uint16 and img.ndim == 2
    if not wide and (img.dtype != np.uint8 or img.ndim not in (2, 3)
                     or (img.ndim == 3 and img.shape[2] != 3)):
        raise ValueError(f"write_png: want (H, W) or (H, W, 3) uint8 or (H, W) uint16, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    data = img.astype(">u2").view(np.uint8) if wide else img
    rows = np.concatenate([np.zeros((h, 1), np.uint8), data.reshape(h, -1)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = 0 if img.ndim == 2 else 2
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16 if wide else 8,
                                                      color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 grayscale (ITU-R 601-2 luma, PIL's integer rounding) as float32."""
    if img.ndim == 2:
        return img.astype(np.float32)
    c = img.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16) \
        .astype(np.float32)


def load_image_gray(path) -> np.ndarray:
    return to_gray(read_png(path))


@dataclasses.dataclass
class Sequence:
    """A loaded sequence: image paths and timestamps (+ depth, IMU)."""

    image_paths: list
    timestamps: np.ndarray                 # seconds
    depth_paths: Optional[list] = None
    depth_factor: float = 1.0
    imu: Optional[np.ndarray] = None       # (M,7) [t ax ay az wx wy wz]

    def __len__(self):
        return len(self.image_paths)

    def image(self, i) -> np.ndarray:
        """Frame i as an (H, W) float32 grayscale image."""
        return load_image_gray(self.image_paths[i])

    def depth(self, i) -> np.ndarray:
        """Depth frame i as (H, W) float32: the raw image / depth_factor."""
        return read_png(self.depth_paths[i]).astype(np.float32) / self.depth_factor

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        """IMU rows with t in (t0, t1] as (N,7) [ax ay az wx wy wz dt]
        blocks, dt of each sample from the one before (the first from t0)."""
        if self.imu is None:
            return np.zeros((0, 7), np.float32)
        t = self.imu[:, 0]
        rows = self.imu[(t > t0) & (t <= t1)]
        if len(rows) == 0:
            return np.zeros((0, 7), np.float32)
        out = np.zeros((len(rows), 7), np.float32)
        out[:, :6] = rows[:, 1:7]
        out[:, 6] = np.diff(np.concatenate([[t0], rows[:, 0]]))
        return out


def _csv_rows(path):
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            yield line.strip().split(",")


def load_euroc(seq_dir, cam: str = "cam0", with_imu: bool = False) -> Sequence:
    """`seq_dir` = .../MH_01_easy/mav0. Timestamps from data.csv
    (nanoseconds), as mono_euroc.cc's LoadImages reads them."""
    cam_dir = os.path.join(seq_dir, cam)
    names, stamps = [], []
    for ts, name, *_ in _csv_rows(os.path.join(cam_dir, "data.csv")):
        names.append(os.path.join(cam_dir, "data", name.strip()))
        stamps.append(int(ts) * 1e-9)
    imu = None
    if with_imu:
        rows = []
        for r in _csv_rows(os.path.join(seq_dir, "imu0", "data.csv")):
            v = [float(x) for x in r]
            # EuRoC columns: t[ns], wx, wy, wz, ax, ay, az
            rows.append([v[0] * 1e-9, v[4], v[5], v[6], v[1], v[2], v[3]])
        imu = np.asarray(rows, np.float64)
    return Sequence(names, np.asarray(stamps), imu=imu)


def _read_tum_list(path):
    entries = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split()
            entries.append((float(parts[0]), parts[1]))
    return entries


def associate(a, b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (evaluation/associate.py)."""
    pairs, used, j = [], set(), 0
    for ta, pa in a:
        best, best_dt = None, max_dt
        for k in range(max(j - 5, 0), len(b)):
            tb = b[k][0]
            dt = abs(tb - ta)
            if dt < best_dt and k not in used:
                best, best_dt = k, dt
            if tb > ta + max_dt:
                break
        if best is not None:
            used.add(best)
            j = best
            pairs.append((ta, pa, b[best][0], b[best][1]))
    return pairs


def load_tum_rgbd(seq_dir, depth_factor: float = 5000.0) -> Sequence:
    """TUM-RGBD: rgb.txt and depth.txt associated by timestamp."""
    pairs = associate(_read_tum_list(os.path.join(seq_dir, "rgb.txt")),
                      _read_tum_list(os.path.join(seq_dir, "depth.txt")))
    return Sequence(image_paths=[os.path.join(seq_dir, p) for _, p, _, _ in pairs],
                    timestamps=np.asarray([t for t, _, _, _ in pairs]),
                    depth_paths=[os.path.join(seq_dir, p) for _, _, _, p in pairs],
                    depth_factor=depth_factor)


def load_tum_vi(seq_dir, cam: str = "cam0", with_imu: bool = True) -> Sequence:
    """TUM-VI: the ASL layout of EuRoC."""
    return load_euroc(seq_dir, cam=cam, with_imu=with_imu)
