"""The loop circuit's landmark ring and its synthetic features.

Frozen copy (commit 0d99d19) of the port's scenes.ring_world, scenes.ring_pose
and models/fake.py (SyntheticWorld's saliency, FakeExtractor's projection,
selection and noise), numpy only: the pinhole projection is written out here.
A frame's "image" is its ground-truth pose; its features are the ring's
landmarks projected through it, the most salient `max_per_frame` of those in
view, with pixel and descriptor noise drawn from one generator in frame order.
The benchmark draws its loop traffic from this file, so a change to the
port's fake extractor leaves it alone.
"""
from __future__ import annotations

import numpy as np


def ring_world(n_landmarks, desc_dim, seed=11, r_min=12.0, r_max=20.0, y_half=4.0,
               center_z=6.0):
    """(landmarks (L,3) float32, unit descriptors (L,D) float32, saliency (L,)):
    landmarks on a ring of radius r_min..r_max about (0, 0, center_z), y within
    +-y_half, drawn from `seed` in the port's order (the saliency last)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_landmarks)
    rr = rng.uniform(r_min, r_max, n_landmarks)
    pts = np.stack([rr * np.sin(th), rng.uniform(-y_half, y_half, n_landmarks),
                    center_z - rr * np.cos(th)], 1).astype(np.float32)
    d = rng.standard_normal((n_landmarks, desc_dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    saliency = rng.uniform(0.0, 1.0, n_landmarks)
    return pts, d, saliency


def ring_pose(i, n_frames, total_angle, radius=6.0, bob=0.15):
    """World->camera (R, t) of frame i, float32: the camera on a circle of
    `radius` about (0, 0, radius), facing outward, bobbing vertically."""
    th = total_angle * i / n_frames
    out = np.array([np.sin(th), 0.0, -np.cos(th)])
    c = np.array([0.0, 0.0, radius]) + radius * out + np.array([0.0, bob * np.sin(0.1 * i), 0.0])
    right = np.cross(np.array([0.0, 1.0, 0.0]), out)
    right /= np.linalg.norm(right)
    R_wc = np.stack([right, np.cross(out, right), out], 1)
    return R_wc.T.astype(np.float32), (-R_wc.T @ c).astype(np.float32)


def global_desc(R_cw, t_cw, dim):
    """Smooth position and heading encoding of a pose, unit-normalized."""
    c = -R_cw.T @ t_cw
    fwd = R_cw.T @ np.array([0, 0, 1.0])
    f = np.concatenate([
        np.sin(np.outer(c, 2.0 ** np.arange(8)).ravel() * 0.25),
        fwd.repeat(8),
        np.cos(np.outer(c, 2.0 ** np.arange(8)).ravel() * 0.25)[:16],
    ])[:dim]
    f = np.pad(f, (0, dim - len(f)))
    return (f / max(np.linalg.norm(f), 1e-9)).astype(np.float32)


class RingFeatures:
    """Features of the ring seen from given poses: __call__(R_cw, t_cw) ->
    dict of numpy arrays xy (N,2), score (N,), octave (N,), desc (N,D),
    mask (N,), global_desc (G,), with N = pad_to. One generator seeded with
    `seed` draws the noise, consecutive calls in call order."""

    def __init__(self, world, cam, seed=7, pad_to=1024, noise_px=0.5, desc_noise=0.02,
                 max_per_frame=900, min_depth=0.3, max_depth=25.0, gdesc_dim=4096):
        self.pts, self.descs, self.saliency = world
        self.cam = dict(cam)
        self.rng = np.random.default_rng(seed)
        self.pad_to, self.noise_px, self.desc_noise = pad_to, noise_px, desc_noise
        self.max_per_frame, self.min_depth, self.max_depth = max_per_frame, min_depth, max_depth
        self.gdesc_dim = gdesc_dim

    def __call__(self, R_cw, t_cw):
        c = self.cam
        R_cw = np.asarray(R_cw, np.float32)
        t_cw = np.asarray(t_cw, np.float32)
        pc = self.pts @ R_cw.T + t_cw
        z = pc[:, 2]
        zc = np.maximum(z, np.float32(1e-6))
        uv = np.stack([np.float32(c["fx"]) * pc[:, 0] / zc + np.float32(c["cx"]),
                       np.float32(c["fy"]) * pc[:, 1] / zc + np.float32(c["cy"])], 1)
        vis = ((z > self.min_depth) & (z < self.max_depth)
               & (uv[:, 0] >= 1) & (uv[:, 0] < c["width"] - 1)
               & (uv[:, 1] >= 1) & (uv[:, 1] < c["height"] - 1))
        ids = np.nonzero(vis)[0]
        if len(ids) > self.max_per_frame:
            ids = ids[np.argsort(-self.saliency[ids])[: self.max_per_frame]]
        n, N, D = len(ids), self.pad_to, self.descs.shape[1]
        xy = np.zeros((N, 2), np.float32)
        desc = np.zeros((N, D), np.float32)
        score = np.zeros((N,), np.float32)
        mask = np.zeros((N,), bool)
        xy[:n] = uv[ids] + self.rng.normal(0, self.noise_px, (n, 2))
        d = self.descs[ids] + self.rng.normal(0, self.desc_noise, (n, D))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        desc[:n] = d
        score[:n] = self.rng.uniform(0.3, 1.0, n)
        mask[:n] = True
        return {"xy": xy, "score": score, "octave": np.zeros((N,), np.int32), "desc": desc,
                "mask": mask, "global_desc": global_desc(R_cw, t_cw, self.gdesc_dim)}
