"""Run RGB-D SLAM on a TUM-RGBD sequence and report ATE.

Counterpart of examples/run_tum_rgbd.py (the reference's rgbd_tum +
eval_tum_rgbd.sh): rgb.txt and depth.txt pair by timestamp
(utils/datasets.load_tum_rgbd), HF-Net extracts each image, and
`track_rgbd` samples the depth map at the keypoints, so the map is metric
from the first frame and the ATE is printed without scale correction.

    python3 -m hfnet_slam_torch.examples.run_tum_rgbd SEQ_DIR --config cfg.yaml \\
        [--weights w.npz] [--out traj.txt] [--gt gt.txt] [--max-frames N] [--device cpu]

RGBD.DepthMapFactor (5000 for TUM) is applied once: the sequence divides the
16-bit depth images by it, and the system takes those metres as they are
(depth_factor 1). Without `--weights` HF-Net has random weights from a fixed
seed. The default device is CUDA. The run switches the port's recorder
(utils/timing.py) on; its report holds the runner's `frame_total` and `load`
(both images) and the program's spans (`frame`, `extract`, `track`, ...).
`main(argv)` returns the (shut down) SLAMSystem.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--config", required=True, help="settings YAML with RGBD.DepthMapFactor")
    ap.add_argument("--weights", default=None, help="HF-Net parameters (.npz)")
    ap.add_argument("--out", default="trajectory_rgbd_tum.txt")
    ap.add_argument("--gt", default=None, help="TUM-format ground truth")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import device as D
    from ..slam.system import SLAMSystem
    from ..utils.datasets import load_tum_rgbd
    from ..utils.settings import SENSOR_RGBD, Settings
    from ..utils.timing import timings
    from .run_euroc_inertial import build_extractor, report_ate

    dev = D.resolve(args.device)
    settings = Settings.from_yaml(args.config, sensor=SENSOR_RGBD)
    cam = settings.make_camera(dev)
    seq = load_tum_rgbd(args.seq_dir, depth_factor=settings.depth_map_factor)
    n = len(seq) if not args.max_frames else min(args.max_frames, len(seq))
    print(f"sequence: {n} rgb-d frames @ {cam.width}x{cam.height} on {dev}")
    # the sequence already returns metres: scale once
    cfg = settings.make_system_config(dev, depth_factor=1.0)
    extractor = build_extractor(settings, cam, cfg.n_slots, args.weights, dev)
    slam = SLAMSystem(cam, extractor, cfg, device=dev)
    timings.enable()
    try:
        for i in range(n):
            with timings.section("frame_total"):
                with timings.section("load"):
                    img, depth = seq.image(i), seq.depth(i)
                st, _, _ = slam.track_rgbd(img, depth, float(seq.timestamps[i]))
            if i % 50 == 0:
                print(f"frame {i}: state={st} kfs={int(slam.store.kf_valid.sum())} "
                      f"mps={int(slam.store.mp_valid.sum())}")
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
