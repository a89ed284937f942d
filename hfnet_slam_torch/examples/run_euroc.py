"""Run monocular SLAM on an EuRoC sequence and report ATE.

Counterpart of examples/run_euroc.py (the reference's mono_euroc +
eval_euroc.sh): the settings file builds the camera and the HF-Net pyramid
extractor, the system runs with the async mapping/loop/GBA pipeline, every
frame goes through `track_monocular` with the port's recorder on
(utils/timing.py: the runner's `frame_total` and `load`, the program's spans),
and after `finish()` the TUM trajectory is written; with `--gt` (TUM format) the
Horn-aligned, scale-corrected ATE is printed.

    python3 -m hfnet_slam_torch.examples.run_euroc SEQ_DIR --config cfg.yaml \\
        [--weights w.npz] [--out traj.txt] [--gt gt.txt] [--max-frames N] [--device cpu]

SEQ_DIR is .../MH_01_easy/mav0. `--weights` is an HF-Net parameter file in
the reference's flat .npz format; without it HF-Net has random weights from
a fixed seed and the descriptors mean nothing. The default device is CUDA.
`main(argv)` returns the (shut down) SLAMSystem for inspection.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--config", required=True, help="settings YAML (the reference's format)")
    ap.add_argument("--weights", default=None, help="HF-Net parameters (.npz)")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None, help="TUM-format ground truth")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import device as D
    from ..models import hfnet
    from ..models.extractor import HFExtractor
    from ..slam.system import SLAMSystem
    from ..utils.datasets import load_euroc
    from ..utils.settings import Settings
    from ..utils.timing import timings

    dev = D.resolve(args.device)
    settings = Settings.from_yaml(args.config)
    cam = settings.make_camera(dev)
    seq = load_euroc(args.seq_dir)
    n = len(seq) if not args.max_frames else min(args.max_frames, len(seq))
    print(f"sequence: {n} frames @ {cam.width}x{cam.height} on {dev}")

    if args.weights:
        net = hfnet.load_params(args.weights, device=dev)
    else:
        print("WARNING: no --weights; random HF-Net (pipeline smoke only)")
        net = hfnet.HFNet(torch.Generator(device=dev).manual_seed(0))
    # async mapping/loop/GBA workers: tracking overlaps local BA and loop
    # closing, as the reference's thread trio
    cfg = settings.make_system_config(async_mapping=True)
    extractor = HFExtractor(net, (cam.height, cam.width), n_features=settings.n_features,
                            n_levels=settings.n_levels, scale_factor=settings.scale_factor,
                            threshold=settings.threshold, pad_to=cfg.n_slots, device=dev)
    slam = SLAMSystem(cam, extractor, cfg, device=dev)
    timings.enable()
    try:
        for i in range(n):
            with timings.section("frame_total"):
                with timings.section("load"):
                    img = seq.image(i)
                st, _, _ = slam.track_monocular(img, float(seq.timestamps[i]))
            if i % 50 == 0:
                print(f"frame {i}: state={st} kfs={int(slam.store.kf_valid.sum())} "
                      f"mps={int(slam.store.mp_valid.sum())}")
        slam.finish()  # drain the async queues; raises a worker's exception
        slam.save_trajectory(args.out)
    finally:
        slam.shutdown()
        timings.disable()
    print(f"trajectory -> {args.out}")
    print(timings.report())

    if args.gt and os.path.exists(args.gt):
        from ..evaluation import ate

        gt = np.loadtxt(args.gt, ndmin=2)
        est = np.loadtxt(args.out, ndmin=2)
        gi = np.clip(np.searchsorted(gt[:, 0], est[:, 0]), 0, len(gt) - 1)
        ok = np.abs(gt[gi, 0] - est[:, 0]) < 0.05
        err = ate.ate_rmse(est[ok, 1:4], gt[gi[ok], 1:4], with_scale=True)
        print(f"ATE RMSE (scale-corrected): {err:.4f} m over {int(ok.sum())} poses")
    return slam


if __name__ == "__main__":
    main()
