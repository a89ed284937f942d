#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (hfnet_slam_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. environment: torch/CUDA versions, the card's name and power limit, TF32
     off;
  2. build: the hand-written kernel (nvcc, sm_90a) and the native map
     library (g++), started together;
  3. kernel vs plain: ops/bf_match.row_top2 against row_top2_reference on the
     card at the slice's and the loop-association shapes in both directions,
     unaligned shapes, a D that is not a multiple of 4, inputs whose base is
     not 16-byte aligned, exact ties, an all-masked B and NB = 1, then the
     gated mutual matcher; times of the kernel, the plain version and a
     library yardstick at four shapes;
  4. the slice: monocular SLAM on the synthetic browse trajectory at
     production widths (1024 slots, 256-d descriptors, 4096-d global
     descriptors), 120 frames, with a 0.1 rad camera jolt from frame 80 on
     that sends tracking through the brute-force kernel.
The line before the last is one JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}. Needs one CUDA card and no
network. Without a card, or without the repository beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# bytes/s, TF32 tensor-core FLOP/s and float32 CUDA-core FLOP/s of one
# H100 SXM at 700 W (NVIDIA's data sheet, dense)
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
H100_FP32_FLOPS = 67e12
TOL_SIM = 1e-5  # f32 over <= 256 unit-norm terms, summed in a different order
TIMED_SHAPES = [(1024, 1024, 256), (1024, 4096, 256), (4096, 1024, 256), (1024, 8192, 256)]


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
def phase_environment(torch):
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    from hfnet_slam_torch import device as D

    D.full_fp32()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul still enabled")
    return smi


def phase_build():
    from hfnet_slam_torch import native
    from hfnet_slam_torch.ops import bf_match

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        kern = ex.submit(bf_match.build, True)
        host = ex.submit(native.get_lib)
        so = kern.result()
        lib = host.result()
    secs = time.perf_counter() - t0
    check(lib is not None, "native map library did not build")
    log(f"build: row_top2.cu (nvcc sm_90a) + mapcore.cpp (g++) in {secs:.2f} s")
    for line in bf_match.ptxas_report():
        log(f"  {line}")
    cuobjdump = os.path.join(os.path.dirname(bf_match.nvcc_command()[0]), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True).stdout.splitlines()
        hgmma = [ln.split(";")[0].split("*/")[-1].strip() for ln in sass if "HGMMA" in ln]
        check(len(hgmma) > 0, "no HGMMA instruction in the row_top2 library")
        log(f"  cuobjdump -sass: {len(hgmma)} HGMMA instructions, e.g. {hgmma[0]}")
    else:
        log("  cuobjdump not found: SASS not checked")
    return secs


def _unit(torch, g, n, d):
    x = torch.randn(n, d, device="cuda", generator=g)
    return x / x.norm(dim=1, keepdim=True)


def _events_ms(torch, run, iters):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _time_ms(torch, fn, iters=50, warm=5):
    """(device ms, eager ms) per call of fn, both CUDA-event means over
    `iters` calls after warm-up. Device ms replays the calls as one CUDA
    graph, so no host work sits between launches; eager ms calls fn in a
    Python loop, where a call's host time can exceed its device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device_ms = _events_ms(torch, graph.replay, iters)

    def eager():
        for _ in range(iters):
            fn()

    eager()
    return device_ms, _events_ms(torch, eager, iters)


def _bound_ms(NA, NB, D):
    """Least time of one call at float32 accuracy: three TF32 tensor-core
    products per multiply-add (3xTF32), against the bytes (inputs once,
    outputs once). Also returns the float32 CUDA-core bound of the
    operations, which a kernel without tensor cores is held to."""
    flops = 2.0 * NA * NB * D
    nbytes = 4.0 * (NA * D + NB * D) + NB + 12.0 * NA
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / H100_FP32_FLOPS * 1e3)


def _misaligned(torch, x):
    """A contiguous copy of x whose base lies 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    off = (1 - buf.data_ptr() // 4) % 4  # elements to skip
    y = buf[off:off + x.numel()].view(x.shape)
    y.copy_(x)
    check(y.is_contiguous() and y.data_ptr() % 16 == 4, "misaligned view is not")
    return y


def phase_kernel(torch):
    from hfnet_slam_torch.ops import bf_match as B

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0

    def compare(label, A, Bm, m):
        nonlocal max_err
        best, second, idx = B.row_top2(A, Bm, m)
        rb, rs, ri = B.row_top2_reference(A, Bm, m)
        torch.cuda.synchronize()
        err = max(float((best - rb).abs().max()), float((second - rs).abs().max()))
        max_err = max(max_err, err)
        bad = (idx != ri).nonzero().flatten()
        if len(bad):  # tell a near-tie from a bug before failing
            S = torch.where(m[None, :], A.double() @ Bm.double().T, -1e9)
            for r in bad[:5].tolist():
                k, p = int(idx[r]), int(ri[r])
                log(f"  row {r}: kernel col {k}, plain col {p}, float64 similarity "
                    f"gap {float(S[r, k] - S[r, p]):.3g}")
        check(len(bad) == 0, f"{label}: idx differs from the plain version in {len(bad)} rows")
        check(err <= TOL_SIM, f"{label}: best/second error {err} > {TOL_SIM}")
        log(f"kernel {label}: idx exact, max |err| {err:.3g}")

    def problem(NA, NB, D):
        A, Bm = _unit(torch, g, NA, D), _unit(torch, g, NB, D)
        n_dup = min(NA, NB) // 4  # a quarter of B are noisy copies of A rows
        Bm[:n_dup] = A[:n_dup] + 0.03 * torch.randn(n_dup, D, device="cuda", generator=g)
        Bm = Bm / Bm.norm(dim=1, keepdim=True)
        return A, Bm, torch.rand(NB, device="cuda", generator=g) > 0.1

    for NA, NB, D in [(1024, 1024, 256), (1000, 777, 256), (130, 4097, 64),
                      (1024, 4096, 256), (4096, 1024, 256), (1024, 8192, 256),
                      (100, 300, 13)]:
        compare(f"({NA},{NB},{D})", *problem(NA, NB, D))
    A, Bm, m = problem(1000, 777, 256)
    compare("(1000,777,256) base 4 bytes past 16-byte alignment",
            _misaligned(torch, A), _misaligned(torch, Bm), m)
    A, Bm = _unit(torch, g, 512, 256), _unit(torch, g, 700, 256)
    Bm[300] = Bm[5]
    Bm[650] = Bm[5]
    Bm[10:20] = Bm[40:50]
    A[:3] = Bm[5]
    A[3:13] = Bm[40:50]
    ones = torch.ones(700, dtype=torch.bool, device="cuda")
    compare("exact ties", A, Bm, ones)
    best, second, idx = B.row_top2(A, Bm, ones)
    check(int(idx[0]) == 5 and float(best[0]) == float(second[0]),
          "exact tie: want the lowest index and second == best")
    compare("all of B masked", A, Bm, torch.zeros(700, dtype=torch.bool, device="cuda"))
    best, second, idx = B.row_top2(A, Bm, torch.zeros(700, dtype=torch.bool, device="cuda"))
    check(bool((best == -1e9).all() & (second == -1e9).all() & (idx == 0).all()),
          "all masked: want best = second = -1e9 and idx = 0")
    compare("NB = 1", A, Bm[:1].contiguous(), ones[:1].contiguous())
    compare("NB = 1 masked", A, Bm[:1].contiguous(), ones[:1].logical_not().contiguous())

    # the gated mutual matcher at the slice's shape, ratio 0.9
    NA = NB = 1024
    A, Bm = _unit(torch, g, NA, 256), _unit(torch, g, NB, 256)
    Bm[:700] = A[:700] + 0.03 * torch.randn(700, 256, device="cuda", generator=g)
    Bm = Bm / Bm.norm(dim=1, keepdim=True)
    mA = torch.rand(NA, device="cuda", generator=g) > 0.1
    mB = torch.rand(NB, device="cuda", generator=g) > 0.1
    iK, dK = B.match_descriptors_fused(A, mA, Bm, mB, max_dist=0.6, ratio=0.9)
    from hfnet_slam_torch.ops import matching as M

    iP, dP = M.match_descriptors(A, mA, Bm, mB, max_dist=0.6, ratio=0.9, mutual=True)
    torch.cuda.synchronize()
    check(torch.equal(iK, iP), "gated matches differ from the plain matcher")
    check(int((iK >= 0).sum()) > 400, "gated matcher found too few matches")
    derr = float((dK - dP).abs().max())
    check(derr <= 1e-4, f"gated distances differ by {derr}")
    log(f"kernel gated (1024,1024,256) ratio 0.9: {int((iK >= 0).sum())} matches, "
        f"indices exact, max |dist err| {derr:.3g}")

    timings = []
    for NA, NB, D in TIMED_SHAPES:
        A, Bm = _unit(torch, g, NA, D), _unit(torch, g, NB, D)
        m = torch.rand(NB, device="cuda", generator=g) > 0.1
        k_ms, k_eager = _time_ms(torch, lambda: B.row_top2(A, Bm, m))
        p_ms, _ = _time_ms(torch, lambda: B.row_top2_reference(A, Bm, m))
        lib_ms, _ = _time_ms(torch, lambda: torch.topk(
            torch.where(m[None, :], A @ Bm.T, -1e9), 2, dim=1))
        bound, by, fp32_bound = _bound_ms(NA, NB, D)
        timings.append({"shape": [NA, NB, D], "ms": k_ms, "eager_ms": k_eager,
                        "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound,
                        "bound_by": by})
        log(f"kernel timing ({NA},{NB},{D}): kernel {k_ms:.4f} ms (eager loop "
            f"{k_eager:.4f} ms), plain {p_ms:.4f} ms, matmul+topk {lib_ms:.4f} ms, "
            f"3xTF32 bound {bound * 1e3:.2f} us ({by}, {100 * bound / k_ms:.1f}% reached), "
            f"FP32 CUDA-core bound {fp32_bound * 1e3:.2f} us")
    return max_err, timings


# ---------------------------------------------------------------------------
def phase_slice(torch, smi):
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.ops import bf_match
    from hfnet_slam_torch.scenes import browse_pose, production_browse_system
    from hfnet_slam_torch.slam.tracking import OK

    n_frames = 120
    sys_, ext = production_browse_system()  # device=None: CUDA
    poses = [browse_pose(i, jolt_at=80) for i in range(n_frames)]
    feats = [ext(R, t) for R, t in poses]  # the stand-in extractor is not timed
    torch.cuda.synchronize()

    bf_match.launches = 0  # count only the main path's launches
    est, gt, frame_ms, kf_frames = [], [], np.zeros(n_frames), []
    for i, (R, t) in enumerate(poses):
        n_kf0 = sys_.store.n_kf
        f0 = time.perf_counter()
        _, Re, te = sys_.track_features(feats[i], 0.05 * i)
        torch.cuda.synchronize()
        frame_ms[i] = (time.perf_counter() - f0) * 1e3
        if sys_.store.n_kf != n_kf0:
            kf_frames.append(i)
        if Re is not None:
            est.append(-Re.T @ te)
            gt.append(-R.T @ t)
    launches = bf_match.launches
    store = sys_.store
    est, gt = np.asarray(est), np.asarray(gt)
    check(store._device_map.pos.device.type == "cuda", "map mirror is not on the card")
    check(store._kf_bank.desc.device.type == "cuda", "keyframe bank is not on the card")
    check(sys_.tracker.state == OK, f"final tracking state {sys_.tracker.state}, want OK")
    check(len(est) >= 105, f"{len(est)} of {n_frames} frames tracked, want >= 105")
    check(launches >= 4, f"row_top2 launched {launches} times on the main path, want >= 4")
    check(np.isfinite(est).all(), "NaN/inf in the tracked poses")
    check(np.isfinite(store.mp_pos[store.mp_valid]).all(), "NaN/inf in the map points")
    ate_m = float(ate.ate_rmse(est, gt, with_scale=True))
    check(ate_m <= 0.01, f"scale-corrected ATE {ate_m} m > 0.01 m")
    steady = frame_ms[40:]
    non_kf = np.asarray([frame_ms[i] for i in range(40, n_frames) if i not in kf_frames])
    res = {
        "frames_tracked": len(est), "frames": n_frames,
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "ate_m": ate_m, "row_top2_launches": launches,
        "frame_ms_p50": float(np.percentile(steady, 50)),
        "frame_ms_p99": float(np.percentile(steady, 99)),
        "tracking_frame_ms_p50": float(np.percentile(non_kf, 50)),
        "keyframe_frames": kf_frames,
        "card": smi,
    }
    log("slice: " + json.dumps(res))
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import hfnet_slam_torch  # noqa: F401  (fails here when run without the repository)

    smi = phase_environment(torch)
    phase_build()
    max_err, timings = phase_kernel(torch)
    launches = phase_slice(torch, smi)

    # the slice's shape leads; the loop-association shapes follow under "shapes"
    kern = {
        "name": "row_top2", "route": "cuda",
        "source": "hfnet_slam_torch/csrc/row_top2.cu",
        "replaces": "hfnet_slam_tpu/ops/pallas_match.py:52",
        "launches": launches, "max_abs_err": max_err,
        **timings[0],
        "bound_peak": "3xTF32 on the tensor cores, 495 TFLOP/s",
        "shapes": timings[1:],
    }
    log(smi)
    log(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
