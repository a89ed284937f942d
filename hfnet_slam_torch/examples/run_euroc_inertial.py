"""Run mono-inertial SLAM on an EuRoC sequence and report ATE.

Counterpart of examples/run_euroc_inertial.py (the reference's
mono_inertial_euroc + eval_euroc.sh): per frame the IMU rows in
(t_prev, t] go to the tracker with the image, in the synchronous pipeline as
the reference's runner; the staged IMU initialization makes the map metric,
so the ATE is printed without scale correction too.

    python3 -m hfnet_slam_torch.examples.run_euroc_inertial SEQ_DIR --config cfg.yaml \\
        [--weights w.npz] [--out traj.txt] [--gt gt.txt] [--max-frames N] [--device cpu]

SEQ_DIR is .../MH_01_easy/mav0 with imu0/data.csv; the settings file carries
the IMU.* keys and IMU.T_b_c1. Without `--weights` HF-Net has random
weights from a fixed seed. The default device is CUDA. The port's recorder
(utils/timing.py) is on for the run, and its report is printed. `main(argv)`
returns the (shut down) SLAMSystem for inspection.
"""
from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--config", required=True, help="settings YAML with the IMU keys")
    ap.add_argument("--weights", default=None, help="HF-Net parameters (.npz)")
    ap.add_argument("--out", default="trajectory_vi_tum.txt")
    ap.add_argument("--gt", default=None, help="TUM-format ground truth")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_extractor(settings, cam, n_slots, weights, dev):
    from ..models import hfnet
    from ..models.extractor import HFExtractor

    if weights:
        net = hfnet.load_params(weights, device=dev)
    else:
        print("WARNING: no --weights; random HF-Net (pipeline smoke only)")
        net = hfnet.HFNet(torch.Generator(device=dev).manual_seed(0))
    return HFExtractor(net, (cam.height, cam.width), n_features=settings.n_features,
                       n_levels=settings.n_levels, scale_factor=settings.scale_factor,
                       threshold=settings.threshold, pad_to=n_slots, device=dev)


def run(slam, seq, n, fps, imu=True, log_every=50, right=None):
    """Feed frames [0, n) with their IMU rows, as stereo pairs with frame i
    of the `right` sequence when one is given; returns nothing."""
    from ..utils.timing import timings

    t_prev = float(seq.timestamps[0]) - 1.0 / fps
    for i in range(n):
        t = float(seq.timestamps[i])
        with timings.section("frame_total"):
            with timings.section("load"):
                img = seq.image(i)
                img_r = right.image(i) if right is not None else None
            rows = seq.imu_between(t_prev, t) if imu else None
            if right is not None and imu:
                st, _, _ = slam.track_stereo_inertial(img, img_r, t, rows)
            elif right is not None:
                st, _, _ = slam.track_stereo(img, img_r, t)
            elif imu:
                st, _, _ = slam.track_monocular_inertial(img, t, rows)
            else:
                st, _, _ = slam.track_monocular(img, t)
        t_prev = t
        if i % log_every == 0:
            print(f"frame {i}: state={st} kfs={int(slam.store.kf_valid.sum())} "
                  f"imu_init={slam.store.imu_initialized}")


def report_ate(out, gt_path):
    import os

    import numpy as np

    from ..evaluation import ate

    if not (gt_path and os.path.exists(gt_path)):
        return
    gt = np.loadtxt(gt_path, ndmin=2)
    est = np.loadtxt(out, ndmin=2)
    gi = np.clip(np.searchsorted(gt[:, 0], est[:, 0]), 0, len(gt) - 1)
    ok = np.abs(gt[gi, 0] - est[:, 0]) < 0.05
    err_s = ate.ate_rmse(est[ok, 1:4], gt[gi[ok], 1:4], with_scale=True)
    err_m = ate.ate_rmse(est[ok, 1:4], gt[gi[ok], 1:4], with_scale=False)
    print(f"ATE RMSE: {err_m:.4f} m metric / {err_s:.4f} m scale-corrected "
          f"over {int(ok.sum())} poses")


def main(argv=None):
    args = parse_args(argv)
    from .. import device as D
    from ..slam.system import SLAMSystem
    from ..utils.datasets import load_euroc
    from ..utils.settings import SENSOR_IMU_MONOCULAR, Settings
    from ..utils.timing import timings

    dev = D.resolve(args.device)
    settings = Settings.from_yaml(args.config, sensor=SENSOR_IMU_MONOCULAR)
    cam = settings.make_camera(dev)
    seq = load_euroc(args.seq_dir, with_imu=True)
    n = len(seq) if not args.max_frames else min(args.max_frames, len(seq))
    print(f"sequence: {n} frames @ {cam.width}x{cam.height} + IMU on {dev}")
    cfg = settings.make_system_config()
    extractor = build_extractor(settings, cam, cfg.n_slots, args.weights, dev)
    slam = SLAMSystem(cam, extractor, cfg, imu_calib=settings.make_imu_calib(), device=dev)
    timings.enable()
    try:
        run(slam, seq, n, settings.fps or 20.0)
        slam.finish()
        slam.save_trajectory(args.out)
    finally:
        slam.shutdown()
        timings.disable()
    print(f"trajectory -> {args.out}")
    print(timings.report())
    report_ate(args.out, args.gt)
    return slam


if __name__ == "__main__":
    main()
