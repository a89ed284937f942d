"""Where the time of a tracked frame goes, on the card.

    python3 -m hfnet_slam_torch.tools.profile_slice [--out DIR]

Runs the production-width browse slice (scenes.production_browse_system,
jolt at frame 80) for 120 frames on CUDA, then profiles `--frames` steady
tracking frames after it with torch.profiler and prints one JSON object:
wall ms per frame, the share of that wall time the card was busy in kernels,
kernel launches per frame, and the ten largest CUDA kernels and CPU-side ops.
The chrome trace goes to DIR/profile_slice_trace.json.gz (gzipped: 20
frames of eager launches are over 64 MB of JSON).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build")
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from ..scenes import browse_pose, production_browse_system

    n_warm = 120
    n = n_warm + args.frames
    sys_, ext = production_browse_system()
    feats = [ext(*browse_pose(i, jolt_at=80)) for i in range(n)]
    for i in range(n_warm):
        sys_.track_features(feats[i], 0.05 * i)
    torch.cuda.synchronize()

    kf0 = sys_.store.n_kf
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n):
            sys_.track_features(feats[i], 0.05 * i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    n_launch = sum(e.count for e in dev)
    top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    top_cpu = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:10]
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "profile_slice_trace.json.gz"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "frames": args.frames, "keyframes_in_window": sys_.store.n_kf - kf0,
        "state": int(sys_.tracker.state),
        "wall_ms_per_frame": wall_ms / args.frames,
        "device_kernel_ms_per_frame": dev_ms / args.frames,
        "device_busy_share": dev_ms / wall_ms,
        "kernel_launches_per_frame": n_launch / args.frames,
        "top_cuda_kernels_ms_per_frame": [
            [e.key[:80], e.self_device_time_total / 1e3 / args.frames, e.count // args.frames]
            for e in top_dev],
        "top_cpu_ops_self_ms_per_frame": [
            [e.key[:80], e.self_cpu_time_total / 1e3 / args.frames, e.count // args.frames]
            for e in top_cpu],
        "frames_tracked_total": len(sys_.trajectory),
    }))


if __name__ == "__main__":
    main()
