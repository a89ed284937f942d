"""Run monocular, stereo or their inertial variants on a TUM-VI sequence and
report ATE.

Counterpart of examples/run_tum_vi.py (the reference's mono_tum_vi,
mono_inertial_tum_vi, stereo_tum_vi and stereo_inertial_tum_vi +
eval_tum_vi.sh): the 512x512 fisheye stream goes through the
KannalaBrandt8 camera (geometry/cameras.kb8) that the settings file
describes.

    python3 -m hfnet_slam_torch.examples.run_tum_vi SEQ_DIR --config cfg.yaml [--imu] \\
        [--stereo] [--weights w.npz] [--out traj.txt] [--gt gt.txt] [--max-frames N] \\
        [--device cpu]

SEQ_DIR is .../dataset-room1_512_16/mav0 (TUM-VI ships EuRoC's layout;
--imu needs imu0/data.csv). `--stereo` adds cam1 as the right camera of the
fisheye rig (Camera2.* and Stereo.T_c1_c2 in the settings): `track_stereo`,
or with `--imu` `track_stereo_inertial`. The port's recorder
(utils/timing.py) is on for the run, and its report is printed. `main(argv)`
returns the (shut down) SLAMSystem.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--config", required=True, help="settings YAML (KannalaBrandt8 camera)")
    ap.add_argument("--imu", action="store_true", help="mono-inertial (mono_inertial_tum_vi)")
    ap.add_argument("--stereo", action="store_true", help="fisheye stereo rig (cam0 + cam1)")
    ap.add_argument("--weights", default=None, help="HF-Net parameters (.npz)")
    ap.add_argument("--out", default="trajectory_tumvi.txt")
    ap.add_argument("--gt", default=None, help="TUM-format ground truth")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import device as D
    from ..slam.system import SLAMSystem
    from ..utils.datasets import load_tum_vi
    from ..utils import settings as ST
    from ..utils.timing import timings
    from .run_euroc_inertial import build_extractor, report_ate, run

    dev = D.resolve(args.device)
    sensor = {(False, False): ST.SENSOR_MONOCULAR, (True, False): ST.SENSOR_IMU_MONOCULAR,
              (False, True): ST.SENSOR_STEREO, (True, True): ST.SENSOR_IMU_STEREO}
    settings = ST.Settings.from_yaml(args.config, sensor=sensor[args.imu, args.stereo])
    cam = settings.make_camera(dev)
    seq = load_tum_vi(args.seq_dir, with_imu=args.imu)
    seq_r = load_tum_vi(args.seq_dir, cam="cam1", with_imu=False) if args.stereo else None
    n = len(seq) if not args.max_frames else min(args.max_frames, len(seq))
    print(f"sequence: {n} frames @ {cam.width}x{cam.height}" + (" stereo" if args.stereo else "")
          + (" + IMU" if args.imu else "") + f" on {dev}")
    cfg = settings.make_system_config(dev)
    extractor = build_extractor(settings, cam, cfg.n_slots, args.weights, dev)
    slam = SLAMSystem(cam, extractor, cfg,
                      imu_calib=settings.make_imu_calib() if args.imu else None, device=dev)
    timings.enable()
    try:
        run(slam, seq, n, settings.fps or 20.0, imu=args.imu, right=seq_r)
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
