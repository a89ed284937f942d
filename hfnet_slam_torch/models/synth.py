"""Synthetic RGB-D world with analytic geometry for CNN-in-the-loop runs.

Counterpart of hfnet_slam_tpu/models/synth.py. No HF-Net checkpoint is in
the repository, so running the real network inside the SLAM loop needs a
world that can be rendered with ground truth everywhere: images for the
extractor, exact per-pixel depth for the RGB-D frontend, exact poses for
evaluation and exact correspondences and corners for the self-supervised
fine-tune (models/selftrain.py).

Geometry: a vertical-axis cylinder wall of radius `wall_radius` around the
camera orbit, so every pixel's ray has a closed-form intersection and the
depth images are exact. The wall texture is a flat base plus hundreds of
distinct oriented-grating blobs (orientation, frequency, phase and contrast
per blob): corner-like, localizable and separable.

The texture, the blob corners, the ray grid, `render_rgbd` and `orbit_pose`
are the reference's float64 numpy, so images and depths equal the
reference's bit for bit. `correspondences` and `corner_cells` project
through geometry/cameras on float32 CPU tensors, where the reference
projects jnp arrays: a point within a hair of the margin or of a cell edge
may land on the other side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras


@dataclasses.dataclass
class CylinderWorld:
    cam: cameras.Camera
    wall_radius: float = 14.0
    center: np.ndarray = None          # cylinder axis point (y-axis aligned)
    tile_wh: tuple = (2048, 512)
    n_blobs: int = 1400
    blob_px: int = 36
    base_gray: float = 50.0
    y_span: float = 16.0               # wall height mapped to tile rows
    seed: int = 5

    def __post_init__(self):
        if self.center is None:
            self.center = np.array([0.0, 0.0, 6.0])
        self._cam_cpu = self.cam.to("cpu")
        rng = np.random.default_rng(self.seed)
        TW, TH = self.tile_wh
        B = self.blob_px
        tex = np.full((TH, TW), self.base_gray, np.float32)
        yy, xx = np.mgrid[0:B, 0:B].astype(np.float32) - B // 2
        env = np.exp(-(xx ** 2 + yy ** 2) / (2 * (B / 4.5) ** 2))
        centers = []
        for _ in range(self.n_blobs):
            th1, th2 = rng.uniform(0, np.pi, 2)
            f1, f2 = rng.uniform(0.35, 1.4, 2)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
            g = (np.sin(f1 * (np.cos(th1) * xx + np.sin(th1) * yy) + ph1)
                 + np.sin(f2 * (np.cos(th2) * xx + np.sin(th2) * yy) + ph2))
            amp = rng.uniform(50, 100)
            cy = int(rng.integers(0, TH - B))
            cx = int(rng.integers(0, TW - B))
            tex[cy:cy + B, cx:cx + B] = np.clip(
                tex[cy:cy + B, cx:cx + B] + amp * env * g / 2.0, 0, 255)
            centers.append((cx + B // 2, cy + B // 2))
        self.tex = tex
        # blob centres -> 3D points on the wall (detector supervision)
        cu = np.asarray([c[0] for c in centers], np.float32)
        cv = np.asarray([c[1] for c in centers], np.float32)
        th = (cu / (TW - 1) - 0.5) * 2 * np.pi
        y = cv / (TH - 1) * self.y_span - self.y_span / 2
        C, R = self.center, self.wall_radius
        self.corners3d = np.stack(
            [C[0] + R * np.sin(th), y, C[2] - R * np.cos(th)], 1).astype(np.float32)

        # pixel ray grid (camera coords, z = 1 plane)
        px = self._params()
        W, H = self.cam.width, self.cam.height
        xs = (np.arange(W) - float(px[2])) / float(px[0])
        ys = (np.arange(H) - float(px[3])) / float(px[1])
        self._rays = np.stack(
            np.broadcast_arrays(xs[None, :], ys[:, None], np.ones((H, W))), -1
        ).astype(np.float64)

    def _params(self):
        return self._cam_cpu.params.numpy()

    def _project(self, pc):
        """float32 (N,3) camera points -> (N,2) pixels, as numpy."""
        return self._cam_cpu.project(torch.as_tensor(np.asarray(pc, np.float32))).numpy()

    # ------------------------------------------------------------------
    def render_rgbd(self, R_cw, t_cw):
        """(H,W) grayscale [0,255] and (H,W) exact depth for a world->camera
        pose, float32. Per-pixel ray / cylinder intersection in closed form."""
        TW, TH = self.tile_wh
        C, RW = self.center, self.wall_radius
        R_wc = np.asarray(R_cw, np.float64).T
        c = -R_wc @ np.asarray(t_cw, np.float64)
        d = self._rays @ R_wc.T
        oc = c - C
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2 * (oc[0] * d[..., 0] + oc[2] * d[..., 2])
        cc = oc[0] ** 2 + oc[2] ** 2 - RW * RW
        disc = np.maximum(b * b - 4 * a * cc, 0.0)
        s = (-b + np.sqrt(disc)) / (2 * np.maximum(a, 1e-12))
        p = c + s[..., None] * d
        th = np.arctan2(p[..., 0] - C[0], -(p[..., 2] - C[2]))
        u = (th / (2 * np.pi) + 0.5) * (TW - 1)
        v = np.clip((p[..., 1] + self.y_span / 2) / self.y_span, 0, 1) * (TH - 1)
        u0 = u.astype(int) % TW
        v0 = np.clip(v.astype(int), 0, TH - 2)
        fu = u - np.floor(u)
        fv = v - v0
        t00 = self.tex[v0, u0]
        t01 = self.tex[v0, (u0 + 1) % TW]
        t10 = self.tex[v0 + 1, u0]
        t11 = self.tex[v0 + 1, (u0 + 1) % TW]
        img = (1 - fv) * ((1 - fu) * t00 + fu * t01) + fv * ((1 - fu) * t10 + fu * t11)
        depth = (p - c) @ R_wc[:, 2]
        return img.astype(np.float32), depth.astype(np.float32)

    def orbit_pose(self, i, rate=0.012, orbit_radius=6.0, bob=0.3):
        """Outward-facing orbit inside the wall: (R_cw, t_cw) at frame i."""
        th = rate * i
        C = self.center
        c = C + np.array([orbit_radius * np.sin(th), bob * np.sin(0.07 * i),
                          -orbit_radius * np.cos(th)])
        fwd = np.array([np.sin(th), 0.0, -np.cos(th)])
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
        return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)

    # ------------------------------------------------------------------
    # ground truth for self-supervision (models/selftrain.py)
    # ------------------------------------------------------------------
    def correspondences(self, pose_a, pose_b, depth_a, n, rng, margin=16):
        """n exact pixel correspondences view A -> view B through the wall
        geometry. Returns (uv_a (m,2), uv_b (m,2)) float32, m <= n."""
        Ra, ta = pose_a
        Rb, tb = pose_b
        H, W = depth_a.shape
        ys = rng.integers(margin, H - margin, n).astype(np.float32)
        xs = rng.integers(margin, W - margin, n).astype(np.float32)
        z = depth_a[ys.astype(int), xs.astype(int)]
        px = self._params()
        xn = (xs - float(px[2])) / float(px[0])
        yn = (ys - float(px[3])) / float(px[1])
        pc = np.stack([xn * z, yn * z, z], 1)
        pw = (pc - ta) @ Ra
        pcb = pw @ Rb.T + tb
        uvb = self._project(pcb)
        ok = (pcb[:, 2] > 0.5) \
            & (uvb[:, 0] > margin) & (uvb[:, 0] < W - margin) \
            & (uvb[:, 1] > margin) & (uvb[:, 1] < H - margin)
        return np.stack([xs, ys], 1)[ok], uvb[ok].astype(np.float32)

    def corner_cells(self, R_cw, t_cw, grid=8):
        """SuperPoint-style detector target of a view: per stride-`grid`
        cell, the 65-way class (position in the cell of a visible blob
        centre, or the dustbin 64)."""
        pc = self.corners3d @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = pc[:, 2]
        uv = self._project(pc)
        W, H = self.cam.width, self.cam.height
        ok = (z > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < W - 1) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < H - 1)
        uv = uv[ok]
        tgt = np.full((H // grid, W // grid), grid * grid, np.int32)
        cx = (uv[:, 0] // grid).astype(int)
        cy = (uv[:, 1] // grid).astype(int)
        cls = (uv[:, 1] % grid).astype(int) * grid + (uv[:, 0] % grid).astype(int)
        tgt[cy, cx] = cls
        return tgt
