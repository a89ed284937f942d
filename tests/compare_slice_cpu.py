"""Run the jolted browse slice through both packages on the CPU and print
one JSON line per package: frames tracked, first tracked frame, keyframes,
map points, brute-force matcher calls, scale-corrected ATE.

    JAX_PLATFORMS=cpu python tests/compare_slice_cpu.py --size small
    JAX_PLATFORMS=cpu python tests/compare_slice_cpu.py --size production

small: 512 slots, 64-d, 60 frames, jolt at 40 (tests/test_torch_slam.py);
production: 1024 slots, 256-d, 4096-d global, 120 frames, jolt at 80
(chip_smoke.py's run, here on the CPU)."""
import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from _torch_parity import PRODUCTION, SMALL, build, run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=["small", "production"], default="small")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(args.threads)
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


if __name__ == "__main__":
    main()
