"""Camera models: pinhole and Kannala-Brandt-8 fisheye, on torch tensors.

Counterpart of hfnet_slam_tpu/geometry/cameras.py. A camera is a small
static-kind record with a flat float32 parameter vector; all functions
broadcast over leading point axes.

Param layout:
  PINHOLE: [fx, fy, cx, cy]
  KB8:     [fx, fy, cx, cy, k0, k1, k2, k3]
`Camera.dist` holds radial-tangential [k1, k2, p1, p2, k3] for a distorted
pinhole rig (keypoints are undistorted once per frame).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import resolve

PINHOLE = 0
KB8 = 1

_Z_MIN = 1e-6


@dataclasses.dataclass(frozen=True)
class Camera:
    kind: int
    params: torch.Tensor  # (4,) or (8,) float32
    width: int
    height: int
    dist: Optional[torch.Tensor] = None

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, params=self.params.to(device),
            dist=None if self.dist is None else self.dist.to(device))

    def project(self, pc):
        return project(self.kind, self.params, pc)

    def unproject(self, uv):
        return unproject(self.kind, self.params, uv)

    def project_jac(self, pc):
        return project_jac(self.kind, self.params, pc)

    def undistort(self, uv):
        if self.dist is None:
            return uv
        return undistort_points(self.params, self.dist, uv)

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        return float(self.params[1])


def _f32(vals, device):
    return torch.tensor([float(v) for v in vals], dtype=torch.float32, device=device)


def pinhole(fx, fy, cx, cy, width, height, dist=None, device=None):
    """dist: optional radial-tangential coefficients (k1,k2[,p1,p2[,k3]]).
    device None means CUDA (`device.resolve`)."""
    device = resolve(device)
    d = None
    if dist is not None:
        vals = [float(v) for v in tuple(dist)][:5]
        if any(vals):
            d = _f32(vals + [0.0] * (5 - len(vals)), device)
    return Camera(PINHOLE, _f32([fx, fy, cx, cy], device), width, height, dist=d)


def kb8(fx, fy, cx, cy, k0, k1, k2, k3, width, height, device=None):
    return Camera(KB8, _f32([fx, fy, cx, cy, k0, k1, k2, k3], resolve(device)),
                  width, height)


def project(kind, params, pc):
    """Camera-frame points (...,3) -> pixels (...,2); z clamped to _Z_MIN.
    params is one camera's (P,) vector or a (...,P) one per point."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    if kind == PINHOLE:
        z = torch.clamp(pc[..., 2], min=_Z_MIN)
        return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)
    if kind == KB8:
        k0, k1, k2, k3 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        r2 = x * x + y * y
        r = torch.sqrt(torch.clamp(r2, min=_Z_MIN * _Z_MIN))
        theta = torch.atan2(r, z)
        th2 = theta * theta
        d = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
        scale = torch.where(r2 < 1e-10, 1.0 / torch.clamp(z, min=_Z_MIN), d / r)
        return torch.stack([fx * scale * x + cx, fy * scale * y + cy], -1)
    raise ValueError(f"unknown camera kind {kind}")


def unproject(kind, params, uv):
    """Pixels (...,2) -> unit-depth bearing (...,3) with z = 1."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    if kind == PINHOLE:
        return torch.stack([mx, my, torch.ones_like(mx)], -1)
    if kind == KB8:
        k = params[4:8]
        r_d = torch.sqrt(torch.clamp(mx * mx + my * my, min=1e-16))
        r_d_c = torch.clamp(r_d, max=math.pi / 2.0)
        theta = r_d_c
        for _ in range(10):  # Newton on d(theta) = r_d (the reference's scan)
            th2 = theta * theta
            poly = 1.0 + th2 * (k[0] + th2 * (k[1] + th2 * (k[2] + th2 * k[3])))
            dd = 1.0 + th2 * (3 * k[0] + th2 * (5 * k[1] + th2 * (7 * k[2] + th2 * 9 * k[3])))
            theta = theta - (theta * poly - r_d_c) / dd
        scale = torch.tan(theta) / torch.clamp(r_d_c, min=1e-12)
        return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], -1)
    raise ValueError(f"unknown camera kind {kind}")


def project_jac(kind, params, pc):
    """d(uv)/d(pc): (...,3) -> (...,2,3) closed form; params as in project."""
    fx, fy = params[..., 0], params[..., 1]
    if kind == PINHOLE:
        x, y = pc[..., 0], pc[..., 1]
        z = torch.clamp(pc[..., 2], min=_Z_MIN)
        zinv = 1.0 / z
        zinv2 = zinv * zinv
        zero = torch.zeros_like(x)
        row_u = torch.stack([fx * zinv, zero, -fx * x * zinv2], -1)
        row_v = torch.stack([zero, fy * zinv, -fy * y * zinv2], -1)
        return torch.stack([row_u, row_v], -2)
    if kind == KB8:
        k0, k1, k2, k3 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        r2 = torch.clamp(x * x + y * y, min=1e-12)
        r = torch.sqrt(r2)
        theta = torch.atan2(r, z)
        th2 = theta * theta
        f_t = theta * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
        fd_t = 1.0 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2 + th2 * 9 * k3)))
        zz_rr = z * z + r2
        dtheta_dx = x * z / (r * zz_rr)
        dtheta_dy = y * z / (r * zz_rr)
        dtheta_dz = -r / zz_rr
        g = f_t / r
        dg_dx = (fd_t * dtheta_dx * r - f_t * x / r) / r2
        dg_dy = (fd_t * dtheta_dy * r - f_t * y / r) / r2
        dg_dz = fd_t * dtheta_dz / r
        row_u = torch.stack([fx * (g + x * dg_dx), fx * x * dg_dy, fx * x * dg_dz], -1)
        row_v = torch.stack([fy * y * dg_dx, fy * (g + y * dg_dy), fy * y * dg_dz], -1)
        return torch.stack([row_u, row_v], -2)
    raise ValueError(f"unknown camera kind {kind}")


def distort_points(params, dist, uv):
    """Ideal-pinhole pixels (...,2) -> distorted pixels (radial-tangential)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


def undistort_points(params, dist, uv):
    """Distorted pixels (...,2) -> ideal-pinhole pixels: 10 fixed-point steps
    of x <- (xd - tangential(x)) / radial(x) (cv::undistortPoints)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=1e-3)
        x, y = (xd - dx) * inv, (yd - dy) * inv
    return torch.stack([fx * x + cx, fy * y + cy], -1)
