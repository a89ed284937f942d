"""Deterministic fake extractor backend for hermetic SLAM runs.

Counterpart of hfnet_slam_tpu/models/fake.py: a fixed synthetic landmark
field is projected through the ground-truth camera pose and emitted as a
Features record of the CNN extractor's shape. It draws from the same numpy
generators in the same order as the reference, so one seed gives the same
keypoint slots, masks and descriptors in both packages; the tensors land on
the port's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras
from .extractor import Features


@dataclasses.dataclass
class SyntheticWorld:
    """A landmark field + descriptor bank."""

    landmarks: np.ndarray  # (L,3)
    descs: np.ndarray      # (L,D) unit rows
    rng: np.random.Generator

    def __post_init__(self):
        # persistent per-landmark saliency: frame-to-frame keypoint selection
        # is stable, as a real detector re-fires on the same corners
        self.saliency = self.rng.uniform(0.0, 1.0, len(self.landmarks))

    @staticmethod
    def corridor(seed=0, n_landmarks=4000, length=30.0, width=6.0, height=4.0,
                 desc_dim=64):
        """Landmarks on the walls of a corridor along +z."""
        rng = np.random.default_rng(seed)
        z = rng.uniform(0.0, length, n_landmarks)
        side = rng.integers(0, 4, n_landmarks)
        u = rng.uniform(0, 1, n_landmarks)
        x = np.where(side == 0, -width / 2, np.where(side == 1, width / 2, (u - 0.5) * width))
        y = np.where(side < 2, (u - 0.5) * height, np.where(side == 2, -height / 2, height / 2))
        pts = np.stack([x, y, z], axis=1)
        d = rng.standard_normal((n_landmarks, desc_dim))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return SyntheticWorld(pts.astype(np.float32), d.astype(np.float32), rng)

    @staticmethod
    def cloud(seed=0, n_landmarks=3000, extent=10.0, center=(0, 0, 8.0), desc_dim=64):
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-extent / 2, extent / 2, (n_landmarks, 3)) + np.asarray(center)
        d = rng.standard_normal((n_landmarks, desc_dim))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return SyntheticWorld(pts.astype(np.float32), d.astype(np.float32), rng)


class FakeExtractor:
    """Drop-in extractor: __call__(R_cw, t_cw) -> Features on `device`.
    It takes the ground-truth pose instead of an image; the SLAM system
    under test never sees that pose."""

    def __init__(self, world: SyntheticWorld, cam: cameras.Camera, pad_to=512,
                 noise_px=0.4, desc_noise=0.05, max_landmarks_per_frame=400, seed=1,
                 min_depth=0.3, max_depth=40.0, gdesc_dim=64, device=None):
        from ..device import resolve

        self.world = world
        self.cam = cam.to("cpu")  # projection runs on the host
        self.pad_to = pad_to
        self.noise_px = noise_px
        self.desc_noise = desc_noise
        self.max_per_frame = max_landmarks_per_frame
        self.rng = np.random.default_rng(seed)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.desc_dim = world.descs.shape[1]
        self.gdesc_dim = gdesc_dim
        self.device = resolve(device)

    def global_desc_at(self, R_cw, t_cw):
        """Smooth position+heading encoding, unit-normalized."""
        c = -R_cw.T @ t_cw
        fwd = R_cw.T @ np.array([0, 0, 1.0])
        f = np.concatenate([
            np.sin(np.outer(c, 2.0 ** np.arange(8)).ravel() * 0.25),
            fwd.repeat(8),
            np.cos(np.outer(c, 2.0 ** np.arange(8)).ravel() * 0.25)[:16],
        ])[: self.gdesc_dim]
        f = np.pad(f, (0, self.gdesc_dim - len(f)))
        return (f / max(np.linalg.norm(f), 1e-9)).astype(np.float32)

    def __call__(self, R_cw, t_cw=None) -> Features:
        if t_cw is None:
            R_cw, t_cw = R_cw  # extractor protocol: one "image" = the pose pair
        R_cw = np.asarray(R_cw, np.float32)
        t_cw = np.asarray(t_cw, np.float32)
        pc = self.world.landmarks @ R_cw.T + t_cw
        z = pc[:, 2]
        uv = self.cam.project(torch.from_numpy(pc))
        if self.cam.dist is not None:
            uv = cameras.distort_points(self.cam.params, self.cam.dist, uv)
        uv = uv.numpy()
        vis = ((z > self.min_depth) & (z < self.max_depth)
               & (uv[:, 0] >= 1) & (uv[:, 0] < self.cam.width - 1)
               & (uv[:, 1] >= 1) & (uv[:, 1] < self.cam.height - 1))
        ids = np.nonzero(vis)[0]
        if len(ids) > self.max_per_frame:
            ids = ids[np.argsort(-self.world.saliency[ids])[: self.max_per_frame]]
        n = len(ids)

        N = self.pad_to
        xy = np.zeros((N, 2), np.float32)
        desc = np.zeros((N, self.desc_dim), np.float32)
        score = np.zeros((N,), np.float32)
        octv = np.zeros((N,), np.int32)
        mask = np.zeros((N,), bool)
        xy[:n] = uv[ids] + self.rng.normal(0, self.noise_px, (n, 2))
        d = self.world.descs[ids] + self.rng.normal(0, self.desc_noise, (n, self.desc_dim))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        desc[:n] = d
        score[:n] = self.rng.uniform(0.3, 1.0, n)
        mask[:n] = True
        self.last_ids = ids  # for test introspection

        dev = self.device
        return Features(
            xy=torch.from_numpy(xy).to(dev), score=torch.from_numpy(score).to(dev),
            octave=torch.from_numpy(octv).to(dev), desc=torch.from_numpy(desc).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            global_desc=torch.from_numpy(self.global_desc_at(R_cw, t_cw)).to(dev))
