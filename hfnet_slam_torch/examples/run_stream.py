"""Serve live SLAM over a socket (the reference's ROS node,
Examples/ROS/HFNet_SLAM/src/ros_mono.cc) and optionally open the live
in-browser viewer.

    python3 -m hfnet_slam_torch.examples.run_stream --port 7007 \\
        [--settings EuRoC.yaml] [--viewer] [--fake] [--frames N] [--device cpu]

Any producer then connects and streams frames (utils/stream.py has the
wire format):

    from hfnet_slam_torch.utils.stream import StreamClient
    cli = StreamClient("127.0.0.1", 7007)
    result = cli.send_image(gray_u8, ts)          # {'state', 'R', 't'}

With `--settings` the system is the settings file's camera with HF-Net
(random weights from seed 0: no checkpoint is in the repository; its width
from `Extractor.depthMultiplier`, default 1.0) and async mapping; without
it, a synthetic demo whose extractor reads the frame index from the
image's first two pixels. `--fake` runs a demo client in-process
for `--frames` frames and exits. The default device is CUDA. `main(argv)`
returns a dict of what it printed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--settings", default=None,
                    help="settings YAML (the reference's format); omit for the synthetic demo")
    ap.add_argument("--viewer", action="store_true", help="also start the live web viewer")
    ap.add_argument("--fake", action="store_true", help="run a demo client in-process")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_system(args):
    """The SLAMSystem `args` describe (see the module docstring)."""
    from .. import device as D
    from ..geometry import cameras
    from ..slam.system import SLAMSystem, SystemConfig

    dev = D.resolve(args.device)
    if args.settings:
        from ..models.extractor import HFExtractor
        from ..utils.settings import Settings, depth_multiplier, make_hfnet

        s = Settings.from_yaml(args.settings)
        cam = s.make_camera(dev)
        cfg = s.make_system_config(dev, async_mapping=True)
        net = make_hfnet(depth_multiplier(args.settings), None, dev)
        ext = HFExtractor(net, (cam.height, cam.width), n_features=s.n_features,
                          n_levels=s.n_levels, scale_factor=s.scale_factor,
                          threshold=s.threshold, pad_to=cfg.n_slots, device=dev)
        return SLAMSystem(cam, ext, cfg, device=dev)

    from ..models.fake import FakeExtractor, SyntheticWorld
    from ..scenes import browse_pose

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device=dev)
    world = SyntheticWorld.cloud(seed=5, n_landmarks=1400, extent=16.0, center=(0, 0, 10.0),
                                 desc_dim=64)
    pose_ext = FakeExtractor(world, cam, pad_to=512, noise_px=0.3, desc_noise=0.03,
                             max_landmarks_per_frame=480, seed=7, device=dev)

    def image_keyed(image):
        i = int(image[0, 0]) * 256 + int(image[0, 1])
        return pose_ext(*browse_pose(i))

    cfg = SystemConfig(k_max=128, m_max=8192, n_slots=512, desc_dim=64, gdesc_dim=64)
    return SLAMSystem(cam, image_keyed, cfg, device=dev)


def demo_image(i, h=48, w=64):
    """The demo's frame i: its index in the first two pixels."""
    img = np.zeros((h, w), np.uint8)
    img[0, 0], img[0, 1] = i // 256, i % 256
    return img


def main(argv=None):
    args = parse_args(argv)
    from ..utils.stream import SLAMStreamServer, StreamClient

    system = build_system(args)
    server = SLAMStreamServer(system, host=args.host, port=args.port)
    out = {"address": list(server.address)}
    print(f"SLAM stream server on {server.address[0]}:{server.address[1]}")
    if args.viewer:
        out["viewer_url"] = system.start_webviewer().url
        print(f"live viewer at {out['viewer_url']}")
    try:
        if args.fake:
            # generous timeout: the first frames pay one-off kernel builds
            cli = StreamClient(*server.address, timeout=600.0)
            t0 = time.perf_counter()
            tracked = 0
            r = None
            try:
                for i in range(args.frames):
                    r = cli.send_image(demo_image(i), 0.05 * i)
                    tracked += r["R"] is not None
            finally:
                cli.close()
            dt = time.perf_counter() - t0
            out.update(frames=args.frames, seconds=dt, fps=args.frames / dt, tracked=tracked,
                       final_state=r["state"] if r else None)
            print(f"{args.frames} frames in {dt:.2f}s ({args.frames / dt:.1f} fps), "
                  f"{tracked} tracked, final state {out['final_state']}")
            return out
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        return out
    finally:
        server.close()
        system.shutdown()


if __name__ == "__main__":
    main()
