"""CylinderWorld: a textured cylinder wall around a camera orbit, rendered
as exact grey images and depth maps, with exact correspondences between
views for the self-supervised weights.

Frozen copy (commit 27c9911) of the port's models/synth.py, numpy only:
the pinhole projection is written out here instead of going through the
port's geometry/cameras. The benchmark draws its frames and its training
pairs from this file, so a change to the port's scenes leaves them alone.
"""
from __future__ import annotations

import numpy as np


class CylinderWorld:
    def __init__(self, cam, wall_radius=14.0, center=(0.0, 0.0, 6.0), tile_wh=(2048, 512),
                 n_blobs=1400, blob_px=36, base_gray=50.0, y_span=16.0, seed=5):
        """cam: dict fx, fy, cx, cy, width, height."""
        self.cam = dict(cam)
        self.wall_radius = wall_radius
        self.center = np.asarray(center, np.float64)
        self.tile_wh = tuple(tile_wh)
        self.y_span = y_span
        rng = np.random.default_rng(seed)
        TW, TH = self.tile_wh
        B = blob_px
        tex = np.full((TH, TW), base_gray, np.float32)
        yy, xx = np.mgrid[0:B, 0:B].astype(np.float32) - B // 2
        env = np.exp(-(xx ** 2 + yy ** 2) / (2 * (B / 4.5) ** 2))
        for _ in range(n_blobs):
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
        self.tex = tex
        c = self.cam
        xs = (np.arange(c["width"]) - float(np.float32(c["cx"]))) / float(np.float32(c["fx"]))
        ys = (np.arange(c["height"]) - float(np.float32(c["cy"]))) / float(np.float32(c["fy"]))
        self._rays = np.stack(np.broadcast_arrays(
            xs[None, :], ys[:, None], np.ones((c["height"], c["width"]))), -1).astype(np.float64)

    def project(self, pc):
        """float32 (N,3) camera points -> (N,2) pixels."""
        c = self.cam
        pc = np.asarray(pc, np.float32)
        z = np.maximum(pc[:, 2], np.float32(1e-6))
        return np.stack([np.float32(c["fx"]) * pc[:, 0] / z + np.float32(c["cx"]),
                         np.float32(c["fy"]) * pc[:, 1] / z + np.float32(c["cy"])], 1)

    def render_rgbd(self, R_cw, t_cw):
        """(H,W) grey [0,255] and exact depth of a world->camera pose, float32."""
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
        t00, t01 = self.tex[v0, u0], self.tex[v0, (u0 + 1) % TW]
        t10, t11 = self.tex[v0 + 1, u0], self.tex[v0 + 1, (u0 + 1) % TW]
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
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
        return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)

    def correspondences(self, pose_a, pose_b, depth_a, n, rng, margin=16):
        """Up to n exact pixel correspondences view A -> view B."""
        Ra, ta = pose_a
        Rb, tb = pose_b
        H, W = depth_a.shape
        c = self.cam
        ys = rng.integers(margin, H - margin, n).astype(np.float32)
        xs = rng.integers(margin, W - margin, n).astype(np.float32)
        z = depth_a[ys.astype(int), xs.astype(int)]
        xn = (xs - float(np.float32(c["cx"]))) / float(np.float32(c["fx"]))
        yn = (ys - float(np.float32(c["cy"]))) / float(np.float32(c["fy"]))
        pc = np.stack([xn * z, yn * z, z], 1)
        pcb = ((pc - ta) @ Ra) @ Rb.T + tb
        uvb = self.project(pcb)
        ok = (pcb[:, 2] > 0.5) & (uvb[:, 0] > margin) & (uvb[:, 0] < W - margin) \
            & (uvb[:, 1] > margin) & (uvb[:, 1] < H - margin)
        return np.stack([xs, ys], 1)[ok], uvb[ok].astype(np.float32)
