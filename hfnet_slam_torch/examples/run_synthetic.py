"""Run the monocular SLAM system on a synthetic scene and report ATE.

The main path end to end through the public API (the reference's
Examples/Monocular apps, but hermetic): a FakeExtractor observing a
synthetic landmark field stands in for HF-Net and a dataset. Prints
progress every 10 frames and the scale-corrected ATE RMSE.

    python3 -m hfnet_slam_torch.examples.run_synthetic [--frames N] \\
        [--scene browse|corridor] [--save-trajectory traj.txt] [--device cpu]

The default device is CUDA. `main(argv)` returns {"frames", "tracked",
"ate_m", "path_m"}; ate_m is None when fewer than 5 frames were tracked.
"""
from __future__ import annotations

import argparse

import numpy as np


def corridor_pose(i, step=0.09, sway=0.3, yaw_amp=0.04):
    """Walking down the corridor: 9 cm a frame along +z, swaying in x and
    yawing slightly."""
    z = 1.0 + step * i
    x = sway * np.sin(0.08 * i)
    yaw = yaw_amp * np.sin(0.05 * i)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T.astype(np.float32), (-R_wc.T @ np.array([x, 0.0, z])).astype(np.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--scene", choices=["browse", "corridor"], default="browse")
    ap.add_argument("--save-trajectory", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(scene, device=None):
    """(SLAMSystem, pose function) of `scene` on `device`."""
    from .. import device as D
    from ..geometry import cameras
    from ..models.fake import FakeExtractor, SyntheticWorld
    from ..scenes import browse_pose
    from ..slam.local_mapping import MapperConfig
    from ..slam.system import SLAMSystem, SystemConfig
    from ..slam.tracking import TrackerConfig

    dev = D.resolve(device)
    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device=dev)
    if scene == "browse":
        world = SyntheticWorld.cloud(seed=5, n_landmarks=1400, extent=16.0,
                                     center=(0, 0, 10.0), desc_dim=64)
        pose_fn, init_par = browse_pose, 4.0
    else:
        world = SyntheticWorld.corridor(seed=3, n_landmarks=2600, length=25.0, width=7.0,
                                        height=5.0, desc_dim=64)
        pose_fn, init_par = corridor_pose, 3.0
    ext = FakeExtractor(world, cam, pad_to=512, noise_px=0.3, desc_noise=0.03,
                        max_landmarks_per_frame=480, seed=7, device=dev)
    cfg = SystemConfig(
        k_max=256, m_max=16384, n_slots=512, desc_dim=64, gdesc_dim=64,
        tracker=TrackerConfig(local_mp_cap=2048, min_init_med_parallax_deg=init_par),
        mapper=MapperConfig(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192, tri_neighbors=5))
    return SLAMSystem(cam, ext, cfg, device=dev), pose_fn


def main(argv=None):
    args = parse_args(argv)
    from ..evaluation import ate

    slam, pose_fn = build(args.scene, args.device)
    est_c, gt_c = [], []
    try:
        for i in range(args.frames):
            R, t = pose_fn(i)
            state, Re, te = slam.track_monocular((R, t), timestamp=0.05 * i)
            if Re is not None:
                est_c.append(-Re.T @ te)
                gt_c.append(-R.T @ t)
            if i % 10 == 0:
                print(f"frame {i:3d}: state={state} inliers={slam.tracker.n_inliers} "
                      f"keyframes={int(slam.store.kf_valid.sum())} "
                      f"map_points={int(slam.store.mp_valid.sum())}")
        slam.finish()
        if args.save_trajectory:
            slam.save_trajectory(args.save_trajectory)
    finally:
        slam.shutdown()

    out = {"frames": args.frames, "tracked": len(est_c), "ate_m": None, "path_m": None}
    if len(est_c) < 5:
        print("TRACKING FAILED (too few tracked frames)")
        return out
    est_c, gt_c = np.asarray(est_c), np.asarray(gt_c)
    err = float(ate.ate_rmse(est_c, gt_c, with_scale=True))
    path = float(np.linalg.norm(np.diff(gt_c, axis=0), axis=1).sum())
    out.update(ate_m=err, path_m=path)
    print(f"tracked {len(est_c)}/{args.frames} frames | "
          f"ATE RMSE (scale-corrected): {err:.4f} m over {path:.1f} m path "
          f"({100 * err / max(path, 1e-9):.2f}%)")
    if args.save_trajectory:
        print("trajectory (TUM format) ->", args.save_trajectory)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ate_m"] is not None else 1)
