"""Run a scene through both packages on the CPU and print one JSON line per
package.

    JAX_PLATFORMS=cpu python tests/compare_slice_cpu.py --size small
    JAX_PLATFORMS=cpu python tests/compare_slice_cpu.py --size production
    JAX_PLATFORMS=cpu python tests/compare_slice_cpu.py --scene loop --size small

browse (the default): the jolted browse slice; frames tracked, first tracked
frame, keyframes, map points, brute-force matcher calls, scale-corrected
ATE. small: 512 slots, 64-d, 60 frames, jolt at 40
(tests/test_torch_slam.py); production: 1024 slots, 256-d, 4096-d global,
120 frames, jolt at 80 (chip_smoke.py's run, here on the CPU).

loop: the loop circuit, sync mode, loop closing on; frames tracked, loop
stats, loop edges, brute-force calls by (NA, NB), pre- and post-correction
ATE by bench.py's sync protocol. small: tests/test_loop.py's 170 frames
(~50 s for the reference, ~35 s for the port); production: bench.py's 330
frames at 1024 slots (chip_smoke.py's circuit; compiles the reference at
full width, which is heavy on host memory).

vi: the visual-inertial scene, sync; frames tracked, IMU stage, keyframes,
vi_init_scale_err and the metric ATE after frame 60 (bench.py's
_vi_metrics protocol). small: tests/test_vi_slam.py's 110 frames at 20 Hz
(~150 s for the reference, mostly compiling, ~70 s for the port);
production: bench.py's 100 frames at 10 Hz at 1024 slots (chip_smoke.py's
phase 10 on the CPU; heavy on host memory)."""
import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (LOOP_PRODUCTION, LOOP_SMALL, PRODUCTION, SMALL, VI_SMALL,  # noqa: E402
                           build, build_loop, build_vi, drive_vi, run, run_loop, vi_metrics)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=["browse", "loop", "vi"], default="browse")
    ap.add_argument("--size", choices=["small", "production"], default="small")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(args.threads)
    if args.scene == "loop":
        return compare_loop(LOOP_SMALL if args.size == "small" else LOOP_PRODUCTION, args.size)
    if args.scene == "vi":
        from hfnet_slam_torch.scenes import VI_PRODUCTION
        return compare_vi(VI_SMALL if args.size == "small" else VI_PRODUCTION, args.size)
    size, n, jolt = (SMALL, 60, 40) if args.size == "small" else (PRODUCTION, 120, 80)
    from hfnet_slam_torch.evaluation import ate

    for pkg in ("tpu", "torch"):
        if pkg == "tpu":
            from hfnet_slam_tpu.slam import search
        else:
            from hfnet_slam_torch.slam import search
        calls = []
        real = search.search_brute_force

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        search.search_brute_force = spy
        try:
            sys_, ext = build(pkg, device="cpu", size=size)
            est, gt, ids = run(sys_, ext, 0, n, jolt_at=jolt)
        finally:
            search.search_brute_force = real
        print(json.dumps({
            "package": "hfnet_slam_" + pkg, "size": args.size, "frames": n,
            "frames_tracked": len(ids), "first_tracked": ids[0] if ids else None,
            "state": int(sys_.tracker.state), "keyframes": int(sys_.store.kf_valid.sum()),
            "map_points": int(sys_.store.mp_valid.sum()), "brute_force_calls": len(calls),
            "ate_m": float(ate.ate_rmse(est, gt, with_scale=True))}), flush=True)


def compare_loop(size, name):
    for pkg in ("tpu", "torch"):
        search = __import__(f"hfnet_slam_{pkg}.slam.search", fromlist=["search"])
        calls = {}
        real = search.search_brute_force

        def spy(dA, mA, dB, mB, **kw):
            key = f"{dA.shape[0]},{dB.shape[0]}"
            calls[key] = calls.get(key, 0) + 1
            return real(dA, mA, dB, mB, **kw)

        search.search_brute_force = spy
        try:
            sys_, ext = build_loop(pkg, device="cpu", size=size)
            pre, post, n_tracked = run_loop(sys_, ext, size)
        finally:
            search.search_brute_force = real
        print(json.dumps({
            "package": "hfnet_slam_" + pkg, "scene": "loop", "size": name,
            "frames": size["frames"], "frames_tracked": n_tracked,
            "loop_stats": sys_.loop_closer.stats,
            "loop_edges": [list(map(int, e)) for e in sys_.store.loop_edges],
            "keyframes": int(sys_.store.kf_valid.sum()), "brute_force_calls": calls,
            "ate_pre_m": pre, "ate_post_m": post}), flush=True)


def compare_vi(size, name):
    for pkg in ("tpu", "torch"):
        sys_, ext = build_vi(pkg, size, device="cpu")
        _, est, gt, when = drive_vi(sys_, ext, [(i, False) for i in range(size["frames"])],
                                    size["frame_dt"], size["grav"])
        scale_err, ate_m, path = vi_metrics(est, gt, when)
        print(json.dumps({
            "package": "hfnet_slam_" + pkg, "scene": "vi", "size": name,
            "frames": size["frames"], "frames_tracked": len(when),
            "imu_initialized": bool(sys_.store.imu_initialized), "stage": int(sys_.vi.stage),
            "keyframes": int(sys_.store.kf_valid.sum()), "vi_init_scale_err": scale_err,
            "ate_vi_metric_m": ate_m, "path_m": path}), flush=True)


if __name__ == "__main__":
    main()
