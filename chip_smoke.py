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
     gated mutual matcher; a repeat-launch stress (25 launches at each timed
     shape and at the small shapes whose column splits merge through the
     last-block ticket, every launch's idx, best and second held against
     the plain version); times of the kernel, the plain version and a
     library yardstick at six shapes;
  4. browse: monocular SLAM on the synthetic browse trajectory at
     production widths (1024 slots, 256-d descriptors, 4096-d global
     descriptors), 120 frames, with a 0.1 rad camera jolt from frame 80 on
     that sends tracking through the brute-force kernel;
  5. loop circuit: bench.py's loop circuit at production widths, 330 frames
     over 2.2 laps, sync mode, loop closing on: corrections, pre- and
     post-correction ATE (bench.py's sync protocol), row_top2 launches by
     shape (loop association runs it at (1024,2048,256) and swapped);
  6. relocalization: the browse scene with frames 55-61 featureless
     (tests/test_reloc.py's blackout) at production widths, 90 frames: the
     track must relocalize into the same map through the kernel;
  7. extraction: scenes.euroc_hfnet_system (HF-Net with seeded random
     weights at EuRoC's 752x480, 1000 features, 4 levels, 1024 slots) on a
     seeded textured image and a copy shifted by (16, 8) px: the Features
     record's fields, norms, bounds, NMS separation and determinism; the
     same extractor code on the CPU against the card; both frames through
     slam/search.search_brute_force (row_top2 at (1024,1024,256) both
     ways, re-checked against its plain version); 20 frames of a texture
     moving 4 px a frame, shaken by 200 px every other frame from frame
     12 on, which sends tracking to the reference keyframe through
     row_top2, through
     track_monocular, plainly and through utils/prefetch.pipeline_frames
     (the kernel re-checked on that path's first matcher inputs);
     extraction times in float32 and bfloat16 (p50 of synced calls,
     sustained, a forward / post-processing split per level by CUDA
     events) and the bf16 keypoints' overlap with the float32 ones;
  8. async loop circuit: phase 5's circuit with async_mapping=True (the
     mapping, loop and GBA worker threads), its first 180 of 330 frames
     (1.2 laps, the revisit included), in bench.py's async protocol:
     frames paced at max(50 ms, 2 x phase 5's p50 from frame 12 on), the
     camera yielding while more than one keyframe waits for mapping (3 s at
     most). Corrections, pre/post/keyframe ATE beside phase 5's, frame p50
     and p99, the first-detection stall, GBA solves completed and aborted,
     the pose-graph solve windows with the frames that finished inside
     them, and row_top2 launches by shape and by thread; after finish(), the
     store's structural invariants (tests/test_stress.py's) under the map
     lock, and the kernel re-checked on the loop thread's first association
     inputs, where no index may differ;
  9. EuRoC runner: a 40-frame synthetic EuRoC sequence (752x480, the
     shake of phase 7) and its settings file through
     `hfnet_slam_torch.examples.run_euroc.main` on the card (async, HF-Net
     with seeded random weights, 1000 features, 4 levels): one TUM line per
     tracked frame, the timing report, row_top2 on the path (re-checked),
     and save_atlas / load_atlas into a fresh system (every array equal; one
     flipped byte refused), for the runner's system and phase 8's;
 10. visual-inertial: bench.py's _vi_metrics scenario at production widths
     (scenes.vi_system(VI_PRODUCTION): 100 frames at 10 Hz with exact 200 Hz
     IMU, sync, loop closing off): the IMU initialized through VIBA1 at
     least, vi_init_scale_err <= 0.03 and ate_vi_metric_m <= 0.2 m and <= 5%
     of the path (bench.py's protocol: Horn alignment over frames > 60;
     BENCH_r05: 0.0091 / 0.0662), frame p50 / p99, the preintegration's rows,
     ms and launches per VI frame (launches from torch.profiler on two
     calls), per-stage ms (the per-frame VI solves, the inertial window BA,
     each init stage, FullInertialBA) and row_top2 launches by shape;
 11. async visual-inertial blackout: tests/test_vi_dropout.py's async plan at
     production widths (its first 80 of 90 frames, 60-69 featureless) with
     that test's assertions, plus at frame 45 every keypoint shifted 40 px with its
     descriptor kept, which sends the frame to the reference keyframe's
     brute force; row_top2 launches by thread and shape, at least 2 on the
     VI path, and the kernel re-checked exactly on the first VI-path call
     with a non-empty maskA;
 12. RGB-D browse: phase 4's scene through track_rgbd, with ground-truth
     depth (0.5% noise) splatted into a 640x480 depth image per frame: at
     least 105 of 120 frames tracked, metric ATE <= 0.25 m and <= 1.5 x the
     scale-corrected ATE + 0.05 m, the map from stereo initialization at
     frame 0, at least 2 row_top2 launches after the jolt, the first
     re-checked with no index differing; frame p50 / p99, keyframes and the
     depth points each created;
 13. stereo browse: the same through track_stereo on a rectified rig (0.1 m
     baseline) with the same limits, plus the share of left slots that
     match_stereo gave a depth and its error against ground truth;
 14. fisheye rig: tests/test_stereo.py's KB8 pair (cam_right and T_lr set)
     at production widths, 60 frames through track_stereo: metric ATE <
     0.08 m, right-bank observations at every keyframe track_stereo creates,
     right-camera edges in every local BA (their count and any dropped at
     the edge cap);
 15. stereo-inertial: the VI scene with a rectified right camera 0.11 m
     away, its first 40 of 60 frames at 10 Hz through
     track_stereo_inertial: IMU stage >= 1, metric ATE <= 0.2 m and <= 5%
     of the path, VI frame p50 / p99;
 16. TUM RGB-D runner: examples/run_tum_rgbd on a 40-frame synthetic
     sequence (HF-Net at full width, random weights from seed 0): one TUM
     line per tracked frame, the first keyframe's median depth within 2% of
     the written depth, extraction and frame p50;
 17. CNN in the loop: bench.py's _cnn_metrics scenario
     (scenes.cnn_system(CNN_PRODUCTION)): HF-Net from the port's seed-0
     weights fine-tuned on the card for 250 steps on a CylinderWorld's exact
     correspondences, then 120 rendered 640x480 RGB-D frames extracted one
     ahead (pipeline_frames) and tracked with async mapping: bench.py's keys
     (cnn_train_s, cnn_e2e_fps, cnn_tracked_frac, cnn_lost, cnn_kf_count,
     cnn_inliers_p50, ate_cnn_m beside the reference's 0.7836 m, cnn_path_m),
     one train step's CUDA-event ms with its forward / backward / Adam split,
     its kernels by torch.profiler and its float32 bound; passes with no
     frame lost, >= 90% tracked, >= 3 keyframes, ATE < 0.35 x the path and
     the last loss < 0.6 x the first. The run also records the mapping
     queue's length at each keyframe decision and the mapper's ms per
     keyframe beside the tracker's ms per frame (`pace`). Then frames 0 and
     4 through the gated mutual matcher on the trained and on the seed-0
     descriptors: the share of matches within 3 px of the true
     correspondence, and row_top2 held exactly to its plain version on the
     trained ones;
 18. mesh: phase 5's final map solved by global BA three ways on copies of
     it: the single solver sized to the map (the port's earlier route),
     the distributed Schur solver on the one-shard default mesh (the
     reference's route past the caps), and on a 4-shard mesh on the card:
     cost over the map's edges, iterations and ms each; passes if the
     distributed route costs no more than 1.001 x the single solver and
     counts dist_gba, and the 1- and 4-shard routes' camera centres agree
     within 2e-3 m (tests/test_torch_parallel.py's TOL_MESH). Then
     install_mesh on a 4-shard mesh and one retrieval against the unmeshed
     scan: equal scores and candidates. NCCL across cards is not checked
     on one card;
 19. stream: phase 9's settings file and 40-frame sequence through
     examples/run_stream.build_system's --settings path (HF-Net at
     752x480, seed-0 weights, async mapping) behind a SLAMStreamServer on
     127.0.0.1 with the web viewer started: the 40 frames streamed as uint8
     images by a StreamClient, each answer a known state, each pose equal to
     the system's trajectory entry to the wire's 6 decimals, row_top2 at
     least twice on the server's handler thread (the first call re-checked,
     no index differing), each round trip's ms (p50, p99) beside phase 9's
     frame_total; after finish() the viewer's state.json at 40 frames and
     the store's keyframe count; the step gate (no answer within 1 s while
     armed, one within 30 s of a step) and a cross-origin POST refused with
     403. Then examples/run_synthetic.main on the corridor scene, 80 frames:
     tracked within 2 frames of the reference's 43 and ATE <= max(2 x its
     0.00186 m, 0.01 m).
Phases 5, 6, 8 and 9 keep the inputs of their first loop-association,
relocalization or matcher calls and, after the phase, hold the kernel against
its plain version on them (matched indices that differ, and by how much in
float64). The kernel's main-path launch counts are zeroed just before each
of phases 4-19's paths and read just after. The line before the last is one JSON
object describing every kernel; the last line is {"ok": true, "device":
{...}}. Needs one CUDA card and no network. Without a card, or without the
repository beside it, it exits non-zero before printing a result.
`--only kernel` runs phases 1-3, `--only vi` phases 1-3, 10 and 11,
`--only stereo` phases 1-3 and 12-16, `--only cnn` phases 1-3 and 17,
`--only mesh` phases 1-3, 5 and 18, and `--only stream` phases 1-3 and 19;
none prints the result lines.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL_SIM = 1e-5  # f32 over <= 256 unit-norm terms, summed in a different order
# the extraction phase holds the card's extractor to the CPU parity tests'
# tolerances (tests/test_torch_extractor.py): at least 99% of slots with the
# same mask and xy within 1e-3 px; descriptors, scores and the global
# descriptor within 1e-4 (float32 convs summed in another order)
EXTRACT_MIN_SHARED = 0.99
EXTRACT_TOL_XY = 1e-3
EXTRACT_TOL_DESC = 1e-4
SHIFT = (16, 8)  # px, (x, y): the second frame of the extraction phase
# depth cuts that keep phases 4-19 inside the time limit: phase 8 drives the
# circuit's first 180 of 330 frames (phase 5 corrects at frames 126 and 152),
# phase 11 the blackout plan's first 80 of 90 frames (recovered from frame
# 70), phase 15 the stereo-inertial run's first 40 of 60 frames (the IMU
# initialized at 2 s, VIBA1 at 3.5 s)
ASYNC_LOOP_FRAMES = 180
VI_BLACKOUT_FRAMES = 80
STEREO_VI_FRAMES = 40
TIMED_SHAPES = [(1024, 1024, 256), (1024, 2048, 256), (2048, 1024, 256), (1024, 4096, 256),
                (4096, 1024, 256), (1024, 8192, 256)]


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
    # a card that gives wrong results from its first kernel call has shown
    # up once; its driver and uncorrected ECC count go in the log
    extra = subprocess.run(["nvidia-smi", "--query-gpu=driver_version,"
                            "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    log(f"driver, uncorrected ECC errors: {extra or 'not reported'}")
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
    from hfnet_slam_torch.tools.peaks import H100_BYTES_PER_S, H100_FP32_FLOPS, H100_TF32_FLOPS

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


STRESS_SHAPES = TIMED_SHAPES + [(130, 4097, 64), (100, 300, 13), (37, 1, 16),
                                (1000, 777, 256)]
STRESS_REPEATS = 25


def stress_kernel(torch, g, problem):
    """Repeat-launch stress: STRESS_REPEATS launches at each timed shape and
    at the small shapes whose column splits merge through the last-block
    ticket, every launch's idx, best and second held against the plain
    version on the same inputs. One machine once gave wrong indices from
    its first call; this tells a card that drifts from a kernel that is
    wrong. Returns the largest |best/second| error."""
    from hfnet_slam_torch.ops import bf_match as B

    n, worst = 0, 0.0
    for NA, NB, D in STRESS_SHAPES:
        A, Bm, m = problem(NA, NB, D)
        rb, rs, ri = B.row_top2_reference(A, Bm, m)
        for rep in range(STRESS_REPEATS):
            best, second, idx = B.row_top2(A, Bm, m)
            n_bad = int((idx != ri).sum())
            err = max(float((best - rb).abs().max()), float((second - rs).abs().max()))
            check(n_bad == 0, f"stress ({NA},{NB},{D}) launch {rep}: idx differs from the "
                  f"plain version in {n_bad} rows")
            check(err <= TOL_SIM, f"stress ({NA},{NB},{D}) launch {rep}: error {err}")
            worst = max(worst, err)
            n += 1
    log(f"kernel stress: {n} launches over {len(STRESS_SHAPES)} shapes, every idx equal "
        f"to the plain version, max |err| {worst:.3g}")
    return worst


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
                      (1024, 2048, 256), (2048, 1024, 256), (1024, 4096, 256),
                      (4096, 1024, 256), (1024, 8192, 256), (100, 300, 13)]:
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
    max_err = max(max_err, stress_kernel(torch, g, problem))

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
def reset_counts():
    """Zero the kernel's launch counts: called just before a path runs."""
    from hfnet_slam_torch.ops import bf_match

    bf_match.reset_counts()


def read_counts():
    from hfnet_slam_torch.ops import bf_match

    return bf_match.launches, {",".join(map(str, k)): v
                               for k, v in sorted(bf_match.shape_launches.items())}


def read_thread_counts():
    """Launches by thread name and shape, {"thread": {"NA,NB,D": n}}."""
    from hfnet_slam_torch.ops import bf_match

    out = {}
    for (name, *shape), v in sorted(bf_match.thread_shape_launches.items()):
        out.setdefault(name, {})[",".join(map(str, shape))] = v
    return out


class MatcherCalls:
    """Wraps slam.search.search_brute_force for one phase: keeps the inputs
    of the first call `want(dB)` accepts while `active()` holds and whose
    result `keep` accepts, and counts the kernel launches made inside such
    calls (from the count of all threads: exact when one thread launches)."""

    def __init__(self, want, active=lambda: True, keep=lambda out: True,
                 take=lambda dA, mA, dB, mB: True):
        from hfnet_slam_torch.slam import search

        self.search, self.real = search, search.search_brute_force
        self.want, self.active, self.keep, self.take = want, active, keep, take
        self.first, self.launches = None, 0

    def __enter__(self):
        from hfnet_slam_torch.ops import bf_match

        def call(dA, mA, dB, mB, **kw):
            if not (self.active() and self.want(dB)):
                return self.real(dA, mA, dB, mB, **kw)
            inputs = [x.clone() for x in (dA, mA, dB, mB)] \
                if self.first is None and self.take(dA, mA, dB, mB) else None
            n0 = bf_match.launches
            out = self.real(dA, mA, dB, mB, **kw)
            self.launches += bf_match.launches - n0
            if inputs is not None and self.keep(out):
                self.first = (inputs, kw)
            return out

        self.search.search_brute_force = call
        return self

    def __exit__(self, *exc):
        self.search.search_brute_force = self.real
        return False


class StageTimes:
    """Host ms and span of each call of named functions, attached for one
    phase: `StageTimes(torch, {"name": (obj, "attr")})`. With `fence` each
    call is fenced by torch.cuda.synchronize, and the fences fall inside the
    phase's frame times, which so include them; without it a call adds two
    clock reads and no device sync, so it does not slow what it watches.
    `spans` holds each call's (start, end, thread name). It patches module
    and object attributes, so a caller that imported a function by name
    bypasses it: the phase checks that every stage it must run recorded a
    call. Restores every attribute on exit."""

    def __init__(self, torch, targets, fence=True):
        self.torch, self.targets, self.fence = torch, targets, fence
        self.ms = {k: [] for k in targets}
        self.spans = {k: [] for k in targets}

    def __enter__(self):
        self.saved = {k: getattr(o, a) for k, (o, a) in self.targets.items()}
        for k, (o, a) in self.targets.items():
            setattr(o, a, self._timed(k, self.saved[k]))
        return self

    def _timed(self, k, fn):
        def run(*args, **kw):
            if self.fence:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if self.fence:
                    self.torch.cuda.synchronize()
                return out
            finally:
                t1 = time.perf_counter()
                self.ms[k].append((t1 - t0) * 1e3)
                self.spans[k].append((t0, t1, threading.current_thread().name))
        return run

    def __exit__(self, *exc):
        for k, (o, a) in self.targets.items():
            setattr(o, a, self.saved[k])
        return False

    def report(self):
        """Per name: total ms, calls, and each call's ms when there are few."""
        return {k: {"ms": sum(v), "calls": len(v), **({"each_ms": v} if len(v) <= 4 else {})}
                for k, v in self.ms.items()}


def recheck(torch, label, captured, exact=False):
    """The kernel against its plain version on a phase's real matcher
    inputs: row_top2 both ways and the gated mutual matcher. Prints how
    many matched indices differ; fails when a differing pick is more than
    TOL_SIM worse in float64 (a bug, not a near-tie), and with `exact` when
    any index differs."""
    from hfnet_slam_torch.ops import bf_match as B
    from hfnet_slam_torch.ops import matching as M

    check(captured is not None, f"{label}: no matcher call was captured")
    (dA, mA, dB, mB), kw = captured
    out = {"shape": [dA.shape[0], dB.shape[0], dA.shape[1]]}
    for name, (X, Y, mY) in (("forward", (dA, dB, mB)), ("swapped", (dB, dA, mA))):
        best, _, idx = B.row_top2(X, Y, mY)
        _, _, ri = B.row_top2_reference(X, Y, mY)
        torch.cuda.synchronize()
        bad = (idx != ri).nonzero().flatten()
        S = torch.where(mY[None, :], X.double() @ Y.double().T, -1e9)
        gaps = [abs(float(S[r, int(ri[r])] - S[r, int(idx[r])])) for r in bad.tolist()]
        out[f"{name}_idx_differ"] = len(gaps)
        out[f"{name}_max_gap"] = max(gaps, default=0.0)
        check(max(gaps, default=0.0) <= TOL_SIM,
              f"{label} {name}: kernel and plain picks {max(gaps, default=0.0)} apart")
    iK, _ = B.match_descriptors_fused(dA, mA, dB, mB, **kw)
    iP, _ = M.match_descriptors(dA, mA, dB, mB, mutual=True, **kw)
    out["matches"] = int((iK >= 0).sum())
    out["gated_idx_differ"] = int((iK != iP).sum())
    log(f"{label} recheck: " + json.dumps(out))
    if exact:
        for k in ("forward_idx_differ", "swapped_idx_differ", "gated_idx_differ"):
            check(out[k] == 0, f"{label}: {out[k]} indices differ ({k})")
    return out


def ate_rmse(est, gt, with_scale):
    """ATE of camera centres, metres; metric without `with_scale`."""
    from hfnet_slam_torch.evaluation import ate

    return float(ate.ate_rmse(np.asarray(est), np.asarray(gt), with_scale=with_scale))


def _ate(est, gt):
    """Scale-corrected ATE of camera centres, metres."""
    return ate_rmse(est, gt, with_scale=True)


def _kf_ate(store, poses):
    """Scale-corrected ATE of the map's keyframe centres against the poses of
    their frames (timestamps 0.05 s apart): bench.py's keyframe ATE."""
    from hfnet_slam_torch.utils import trajectory as TJ

    est, gt = [], []
    for ts, R_e, t_e in TJ.keyframe_trajectory(store):
        R, t = poses[int(round(ts / 0.05))]
        est.append(-R_e.T @ t_e)
        gt.append(-R.T @ t)
    return _ate(est, gt)


def phase_slice(torch, smi):
    from hfnet_slam_torch.scenes import browse_pose, production_browse_system
    from hfnet_slam_torch.slam.tracking import OK

    n_frames = 120
    sys_, ext = production_browse_system()  # device=None: CUDA
    poses = [browse_pose(i, jolt_at=80) for i in range(n_frames)]
    feats = [ext(R, t) for R, t in poses]  # the stand-in extractor is not timed
    torch.cuda.synchronize()

    reset_counts()  # count only the main path's launches
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
    launches, by_shape = read_counts()
    store = sys_.store
    est, gt = np.asarray(est), np.asarray(gt)
    check(store._device_map.pos.device.type == "cuda", "map mirror is not on the card")
    check(store._kf_bank.desc.device.type == "cuda", "keyframe bank is not on the card")
    check(sys_.tracker.state == OK, f"final tracking state {sys_.tracker.state}, want OK")
    check(len(est) >= 105, f"{len(est)} of {n_frames} frames tracked, want >= 105")
    check(launches >= 4, f"row_top2 launched {launches} times on the main path, want >= 4")
    check(np.isfinite(est).all(), "NaN/inf in the tracked poses")
    check(np.isfinite(store.mp_pos[store.mp_valid]).all(), "NaN/inf in the map points")
    ate_m = _ate(est, gt)
    check(ate_m <= 0.01, f"scale-corrected ATE {ate_m} m > 0.01 m")
    steady = frame_ms[40:]
    non_kf = np.asarray([frame_ms[i] for i in range(40, n_frames) if i not in kf_frames])
    res = {
        "frames_tracked": len(est), "frames": n_frames,
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "ate_m": ate_m, "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "frame_ms_p50": float(np.percentile(steady, 50)),
        "frame_ms_p99": float(np.percentile(steady, 99)),
        "tracking_frame_ms_p50": float(np.percentile(non_kf, 50)),
        "keyframe_frames": kf_frames,
        "card": smi,
    }
    log("slice: " + json.dumps(res))
    return launches, by_shape


def phase_loop(torch, smi):
    """The production loop circuit, sync mode, loop closing on."""
    from hfnet_slam_torch.optim import pose_graph, sim3
    from hfnet_slam_torch.scenes import LOOP_PRODUCTION, loop_system, ring_pose
    from hfnet_slam_torch.slam import retrieval
    from hfnet_slam_torch.utils import trajectory as TJ

    size = LOOP_PRODUCTION
    n, win = size["frames"], size["loop"]["window_mp_cap"]
    sys_, ext = loop_system(size)  # device=None: CUDA
    poses = [ring_pose(i, n, size["total_angle"]) for i in range(n)]
    feats = [ext(R, t) for R, t in poses]
    torch.cuda.synchronize()
    lc = sys_.loop_closer

    stages = StageTimes(torch, {
        "retrieval": (retrieval, "detect_n_best_candidates"),
        "match_candidate": (lc, "_match_candidate"),
        "sim3_ransac": (sim3, "sim3_ransac"),
        "optimize_sim3": (sim3, "optimize_sim3"),
        "refine_from_last_kf": (lc, "_refine_from_last_kf"),
        "fuse_loop_points": (lc, "_fuse_loop_points"),
        "pose_graph": (pose_graph, "optimize_pose_graph"),
        "global_ba": (sys_.mapper, "run_global_ba"),
        "local_mapping": (sys_.mapper, "process_keyframe")})
    reset_counts()
    live, gt, frame_ms, corr_ms = [], [], np.zeros(n), {}
    with MatcherCalls(lambda dB: dB.shape[0] == win) as loop_calls, stages:
        for i, (R, t) in enumerate(poses):
            c0 = lc.stats["corrected"]
            f0 = time.perf_counter()
            _, Re, te = sys_.track_features(feats[i], 0.05 * i)
            torch.cuda.synchronize()
            frame_ms[i] = (time.perf_counter() - f0) * 1e3
            if lc.stats["corrected"] != c0:
                corr_ms[i] = frame_ms[i]
            if Re is not None:
                live.append(-Re.T @ te)
                gt.append(-R.T @ t)
    launches, by_shape = read_counts()
    store = sys_.store
    # bench.py's sync protocol: pre = the track-time poses of every tracked
    # frame; post = the poses rebuilt through the final map's keyframes
    rec, _, _ = TJ.recovered_resolved(sys_.trajectory, store=store)
    rc, rg = [], []
    for ts, R_e, t_e in rec:
        R, t = poses[int(round(ts / 0.05))]
        rc.append(-R_e.T @ t_e)
        rg.append(-R.T @ t)
    pre = _ate(live, gt)
    post = _ate(rc, rg) if len(rc) > 20 else float("nan")
    res = {
        "frames_tracked": len(live), "frames": n, "corrections": lc.stats["corrected"],
        "detected": lc.stats["detected"], "checked": lc.stats["checked"],
        "refined": lc.stats["refined"], "loop_edges": len(store.loop_edges),
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "ate_pre_m": pre, "ate_post_m": post, "ate_kf_m": _kf_ate(store, poses),
        "recovered_frames": len(rc),
        "first_optimize_sim3_ms": stages.ms["optimize_sim3"][0]
        if stages.ms["optimize_sim3"] else None,
        "frame_ms_p50": float(np.percentile(frame_ms[12:], 50)),
        "frame_ms_p99": float(np.percentile(frame_ms[12:], 99)),
        "correction_frame_ms": {str(k): v for k, v in corr_ms.items()},
        "stage_ms": stages.report(),
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "card": smi,
    }
    log("loop: " + json.dumps(res))
    check(np.isfinite(np.asarray(live)).all(), "NaN/inf in the tracked poses")
    check(np.isfinite(store.mp_pos[store.mp_valid]).all(), "NaN/inf in the map points")
    check(np.isfinite(store.kf_t[store.kf_valid]).all(), "NaN/inf in the keyframe poses")
    check(lc.stats["corrected"] >= 1, f"no loop correction ({lc.stats})")
    # a correction runs each of these stages at least once
    for name in ("retrieval", "match_candidate", "sim3_ransac", "optimize_sim3",
                 "fuse_loop_points", "pose_graph", "global_ba", "local_mapping"):
        check(len(stages.ms[name]) >= 1, f"stage {name} recorded no call")
    check(post <= 0.03, f"post-correction ATE {post} m > 0.03 m")
    check(post <= pre, f"post-correction ATE {post} m > pre-correction {pre} m")
    N, D = sys_.cfg.n_slots, sys_.cfg.desc_dim
    for shape in (f"{N},{win},{D}", f"{win},{N},{D}"):
        check(by_shape.get(shape, 0) >= 1, f"row_top2 never launched at ({shape})")
    rech = recheck(torch, "loop association", loop_calls.first)
    return launches, by_shape, rech, res, sys_


def phase_reloc(torch, smi):
    """tests/test_reloc.py's blackout at production widths."""
    from hfnet_slam_torch.models.extractor import Features
    from hfnet_slam_torch.scenes import BLACKOUT, PRODUCTION, browse_pose, browse_system, reloc_spec
    from hfnet_slam_torch.slam.tracking import OK, RECENTLY_LOST

    n = 90
    sys_, ext = browse_system(PRODUCTION, spec=reloc_spec)  # device=None: CUDA
    N, D, G = sys_.cfg.n_slots, sys_.cfg.desc_dim, sys_.cfg.gdesc_dim
    z = dict(device=sys_.device)
    empty = Features(xy=torch.zeros((N, 2), **z), score=torch.zeros(N, **z),
                     octave=torch.zeros(N, dtype=torch.int32, **z),
                     desc=torch.zeros((N, D), **z), mask=torch.zeros(N, dtype=torch.bool, **z),
                     global_desc=torch.zeros(G, **z))
    feats = [empty if i in BLACKOUT else ext(*browse_pose(i)) for i in range(n)]
    torch.cuda.synchronize()

    reset_counts()
    states, frame_ms = [], np.zeros(n)
    tracker = sys_.tracker
    with MatcherCalls(lambda dB: True, lambda: tracker.state == RECENTLY_LOST) as reloc_calls:
        for i in range(n):
            f0 = time.perf_counter()
            st, _, _ = sys_.track_features(feats[i], 0.05 * i)
            torch.cuda.synchronize()
            frame_ms[i] = (time.perf_counter() - f0) * 1e3
            states.append(int(st))
    launches, by_shape = read_counts()
    lost = [i for i, st in enumerate(states) if st == RECENTLY_LOST]
    back = [i for i in range(lost[0], n) if states[i] == OK] if lost else []
    res = {"frames": n, "recently_lost_frames": lost, "relocalized_at": back[0] if back else None,
           "n_relocalizations": tracker.n_relocalizations, "maps": sys_.atlas.n_maps(),
           "final_state": states[-1], "reloc_row_top2_launches": reloc_calls.launches,
           "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
           "reloc_frame_ms": frame_ms[back[0]] if back else None, "card": smi}
    log("relocalization: " + json.dumps(res))
    check(bool(lost), "the blackout never sent tracking to RECENTLY_LOST")
    check(bool(back), "no relocalization back to OK after the blackout")
    check(tracker.n_relocalizations >= 1, "n_relocalizations is 0")
    check(sys_.atlas.n_maps() == 1, f"{sys_.atlas.n_maps()} maps: relocalization fell back "
          "to a new map")
    check(reloc_calls.launches >= 1 and by_shape.get(f"{N},{N},{D}", 0) >= 1,
          f"row_top2 was not launched by relocalization at ({N},{N},{D})")
    rech = recheck(torch, "relocalization", reloc_calls.first)
    return launches, by_shape, rech, reloc_calls.launches


def _slot_agreement(torch, f, g):
    """(share of f's valid slots whose slot in g has the same mask and xy
    within EXTRACT_TOL_XY, mask of those slots)."""
    same = (f.mask == g.mask) & ((f.xy - g.xy).abs().amax(1) <= EXTRACT_TOL_XY)
    ok = same & f.mask
    return float(ok.sum()) / max(int(f.mask.sum()), 1), ok


def _keypoint_overlap(torch, f, g, tol=1.0):
    """Share of f's valid keypoints with a valid keypoint of g at the same
    octave within tol px."""
    hits, n = 0, 0
    for o in range(int(f.octave.max()) + 1):
        a = f.xy[f.mask & (f.octave == o)]
        b = g.xy[g.mask & (g.octave == o)]
        n += len(a)
        if len(a) and len(b):
            hits += int((torch.cdist(a, b).amin(1) <= tol).sum())
    return hits / max(n, 1)


def _extraction_times(torch, ext, image, n=30, warm=5, reps=3):
    """(p50 ms of n synced calls after warm-up, sustained ms: best of `reps`
    runs of n back-to-back calls with one sync, as bench.py measures)."""
    for _ in range(warm):
        ext(image)
    torch.cuda.synchronize()
    synced = []
    for _ in range(n):
        t0 = time.perf_counter()
        ext(image)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            out = ext(image)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
    del out
    return float(np.percentile(synced, 50)), best


def _level_split(torch, ext, image, n=10):
    """Mean ms per level of the network forward and of the post-processing
    (NMS, selection, refinement, sampling), by CUDA events recorded around
    the extractor's two per-level steps over n back-to-back calls."""
    marks = []

    def timed(kind, fn):
        def run(lvl, *args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(lvl, *args)
            b.record()
            marks.append((f"L{lvl} {kind}", a, b))
            return out
        return run

    ext._forward_level = timed("forward", ext._forward_level)
    ext._post_level = timed("post", ext._post_level)
    try:
        for _ in range(n):
            ext(image)
        torch.cuda.synchronize()
    finally:
        del ext._forward_level, ext._post_level
    split = {}
    for name, a, b in marks:
        split.setdefault(name, []).append(a.elapsed_time(b))
    return {k: float(np.mean(v)) for k, v in split.items()}


def _track_run(torch, sys_, frames, pipelined):
    """Feed frames through track_monocular, or through pipeline_frames and
    track_features. Returns (states, frame ms, launches, launches by shape,
    the features the pipeline handed over, the inputs of the run's first
    brute-force matcher call)."""
    from hfnet_slam_torch.utils.prefetch import pipeline_frames

    torch.cuda.synchronize()
    reset_counts()
    states, ms, handed = [], [], []
    with MatcherCalls(lambda dB: True) as calls:
        if pipelined:
            t0 = time.perf_counter()
            for i, (_, feats) in enumerate(pipeline_frames(sys_.extractor, frames)):
                st, _, _ = sys_.track_features(feats, 0.05 * i)
                handed.append(feats)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ms.append((t1 - t0) * 1e3)
                t0 = t1
                states.append(int(st))
        else:
            for i, img in enumerate(frames):
                t0 = time.perf_counter()
                st, _, _ = sys_.track_monocular(img, 0.05 * i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                states.append(int(st))
    launches, by_shape = read_counts()
    return states, ms, launches, by_shape, handed, calls.first


def phase_extraction(torch, smi):
    """HF-Net extraction on the card at EuRoC's size, behind the tracker."""
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.scenes import EUROC_HFNET, SHAKE, euroc_hfnet_system, textured_image
    from hfnet_slam_torch.slam import search
    from hfnet_slam_torch.slam.tracking import TrackerConfig
    from hfnet_slam_torch.tools import extract_breakdown as XB
    from hfnet_slam_torch.tools.peaks import H100_FP32_FLOPS

    sys_ = euroc_hfnet_system()  # device=None: CUDA
    ext = sys_.extractor
    H, W = ext.image_hw
    N = ext.pad_to
    dx, dy = SHIFT
    n_frames, step = 20, 4
    shake_at, shake = SHAKE
    canvas = textured_image(np.random.default_rng(0), H + dy,
                            W + max(dx, step * n_frames + shake))
    img_a = canvas[dy:dy + H, dx:dx + W]  # the second frame sees it moved by (+dx, +dy)
    img_b = canvas[:H, :W]

    fa, fb = ext(img_a), ext(img_b)
    torch.cuda.synchronize()
    types = (torch.float32, torch.float32, torch.int32, torch.float32, torch.bool, torch.float32)
    for f in (fa, fb):
        check(all(x.device.type == "cuda" for x in f), "a Features field is not on the card")
        check(tuple(x.dtype for x in f) == types, f"Features dtypes {[x.dtype for x in f]}")
        check(f.xy.shape == (N, 2) and f.desc.shape == (N, 256) and
              f.global_desc.shape == (4096,), "Features shapes")
        check(all(bool(torch.isfinite(x).all()) for x in (f.xy, f.score, f.desc, f.global_desc)),
              "NaN/inf in the features")
        m = f.mask
        check(int(m.sum()) >= 500, f"only {int(m.sum())} valid keypoints")
        nerr = float((torch.linalg.norm(f.desc[m], dim=1) - 1).abs().max())
        check(nerr <= 1e-4, f"valid descriptors off unit norm by {nerr}")
        gerr = abs(float(torch.linalg.norm(f.global_desc)) - 1)
        check(gerr <= 1e-4, f"global descriptor off unit norm by {gerr}")
        xy = f.xy[m]
        check(bool((xy >= 0).all() & (xy[:, 0] < W).all() & (xy[:, 1] < H).all()),
              "a keypoint outside the image")
        l0 = f.xy[m & (f.octave == 0)]
        d = torch.cdist(l0, l0) + 1e9 * torch.eye(len(l0), device=l0.device)
        check(float(d.min()) > 4.0, f"level-0 keypoints {float(d.min())} px apart (NMS)")
    again = ext(img_a)
    check(all(torch.equal(x, y) for x, y in zip(fa, again)), "two calls on one image differ")

    # the same port code with the same weights on the CPU
    ext_cpu = HFExtractor(ext.net, (H, W), **EUROC_HFNET, device="cpu")
    fc = ext_cpu(img_a)
    share, ok = _slot_agreement(torch, fa.to("cpu"), fc)
    desc_err = float((fa.desc.cpu() - fc.desc)[ok].abs().max())
    score_err = float((fa.score.cpu() - fc.score)[ok].abs().max())
    gdesc_err = float((fa.global_desc.cpu() - fc.global_desc).abs().max())
    del ext_cpu
    cpu = {"valid_slots_card": int(fa.mask.sum()), "valid_slots_cpu": int(fc.mask.sum()),
           "share_xy_within_1e-3": share, "desc_max_abs_err": desc_err,
           "score_max_abs_err": score_err, "global_desc_max_abs_err": gdesc_err}
    log("extraction card vs cpu: " + json.dumps(cpu))
    check(share >= EXTRACT_MIN_SHARED, f"card and CPU agree on {share:.4f} of the slots")
    check(max(desc_err, score_err, gdesc_err) <= EXTRACT_TOL_DESC,
          f"card vs CPU errors {desc_err}, {score_err}, {gdesc_err} > {EXTRACT_TOL_DESC}")

    # the two frames through the brute-force matcher, as reference-keyframe
    # tracking and relocalization call it
    kw = dict(max_dist=TrackerConfig().th_low, ratio=0.9)
    reset_counts()
    idx, _ = search.search_brute_force(fa.desc, fa.mask, fb.desc, fb.mask, **kw)
    torch.cuda.synchronize()
    n_match, shapes_match = read_counts()
    check(n_match >= 2 and shapes_match.get(f"{N},{N},256", 0) >= 2,
          f"row_top2 launched {shapes_match} on the HF-Net descriptors, want >= 2 at "
          f"({N},{N},256)")
    rech = recheck(torch, "extraction matcher", ((fa.desc, fa.mask, fb.desc, fb.mask), kw))
    hit = idx >= 0
    moved = fb.xy[idx[hit].long()] - fa.xy[hit]
    shift = torch.tensor([float(dx), float(dy)], device=moved.device)
    consistent = float((torch.linalg.norm(moved - shift, dim=1) < 1.5).float().mean()) \
        if bool(hit.any()) else 0.0

    # 20 frames of a texture moving 4 px a frame, shaken from frame 12 on,
    # plainly and pipelined
    offs = [step * i + (shake if i >= shake_at and (i - shake_at) % 2 == 0 else 0)
            for i in range(n_frames)]
    frames = [np.ascontiguousarray(canvas[:H, o:o + W]) for o in offs]
    st_plain, ms_plain, n_plain, shapes_plain, _, track_call = _track_run(
        torch, sys_, frames, False)
    sys2 = euroc_hfnet_system()
    st_pipe, ms_pipe, n_pipe, shapes_pipe, handed, _ = _track_run(torch, sys2, frames, True)
    for img, feats in zip(frames, handed):
        check(all(torch.equal(x, y) for x, y in zip(feats, ext(img))),
              "features handed over by pipeline_frames differ from a direct call")
    del sys2, handed
    for name, n, shapes in (("plain", n_plain, shapes_plain), ("pipelined", n_pipe, shapes_pipe)):
        check(n >= 2 and shapes.get(f"{N},{N},256", 0) >= 2,
              f"track_monocular ({name}) launched row_top2 {shapes} in the shake, want "
              f">= 2 at ({N},{N},256)")
    rech_track = recheck(torch, "extraction tracking", track_call)

    # times: float32 and bfloat16, the image already on the card as bench.py has it
    img_dev = torch.from_numpy(img_a).cuda()
    ext_bf16 = HFExtractor(ext.net, (H, W), **EUROC_HFNET, dtype=torch.bfloat16)
    times = {}
    for name, e in (("float32", ext), ("bfloat16", ext_bf16)):
        p50, sustained = _extraction_times(torch, e, img_dev)
        times[name] = {"p50_ms": p50, "sustained_ms": sustained,
                       "level_split_ms": _level_split(torch, e, img_dev)}
    f16 = ext_bf16(img_a)
    overlap = _keypoint_overlap(torch, fa, f16)
    costs = [XB.forward_cost(h, w, lvl == 0) for lvl, (h, w) in enumerate(ext.level_hw)]
    flops = sum(c["flops"] for c in costs)
    res = {
        "image_hw": [H, W], "level_hw": ext.level_hw, "budgets": ext.budgets,
        "valid_keypoints": [int(fa.mask.sum()), int(fb.mask.sum())],
        "card_vs_cpu": cpu, "matcher": {"launches": n_match, "by_shape": shapes_match,
                                        "mutual_matches": int(hit.sum()),
                                        "shift_consistent_share": consistent},
        "track_plain": {"states": st_plain, "frame_ms_p50": float(np.percentile(ms_plain, 50)),
                        "row_top2_launches": n_plain, "by_shape": shapes_plain},
        "track_pipelined": {"states": st_pipe,
                            "frame_ms_p50": float(np.percentile(ms_pipe, 50)),
                            "row_top2_launches": n_pipe, "by_shape": shapes_pipe},
        "times": times, "bf16_keypoint_overlap": overlap,
        "forward_gflop": flops / 1e9, "forward_fp32_bound_ms": flops / H100_FP32_FLOPS * 1e3,
        "card": smi,
    }
    log("extraction: " + json.dumps(res))
    track_shapes = {}
    for d in (shapes_plain, shapes_pipe):
        for k, v in d.items():
            track_shapes[k] = track_shapes.get(k, 0) + v
    return (n_plain + n_pipe, track_shapes, rech_track), (n_match, shapes_match, rech)



def check_store_invariants(store):
    """tests/test_stress.py's structural invariants of a map that the
    concurrent association paths (tracker claims, fuse replacements,
    culling, merges) must keep. Call under the map lock."""
    obs = store.kf_obs.copy()
    obs[~store.kf_valid] = -1
    counts = np.zeros(store.m_max, np.int32)
    live = obs[obs >= 0]
    np.add.at(counts, live, 1)
    check(np.array_equal(counts, store.mp_obs_count), "mp_obs_count out of sync with kf_obs")
    check(bool(store.mp_valid[live].all()), "an observation of a removed point")
    check(bool(np.isfinite(store.kf_R[store.kf_valid]).all()), "NaN/inf in keyframe rotations")
    check(bool(np.isfinite(store.kf_t[store.kf_valid]).all()), "NaN/inf in keyframe positions")
    check(bool(np.isfinite(store.mp_pos[store.mp_valid]).all()), "NaN/inf in the map points")


def phase_loop_async(torch, smi, sync):
    """Phase 5's circuit in the async pipeline, bench.py's async protocol.
    `sync` is phase 5's result (its p50 sets the pace)."""
    from hfnet_slam_torch.ops import bf_match
    from hfnet_slam_torch.optim import pose_graph, sim3
    from hfnet_slam_torch.scenes import LOOP_PRODUCTION, loop_system, ring_pose
    from hfnet_slam_torch.utils import trajectory as TJ

    size = LOOP_PRODUCTION
    n, win = size["frames"], size["loop"]["window_mp_cap"]
    sys_, ext = loop_system(size, async_mapping=True)  # device=None: CUDA
    poses = [ring_pose(i, n, size["total_angle"]) for i in range(ASYNC_LOOP_FRAMES)]
    feats = [ext(R, t) for R, t in poses]
    torch.cuda.synchronize()
    lc, gba = sys_.loop_closer, sys_.gba_worker
    pace = max(0.05, 2.0 * sync["frame_ms_p50"] / 1e3)
    on_loop = lambda: threading.current_thread().name == "hfnet-loop"  # noqa: E731
    # keep the first loop-thread association that passes on to Sim3 RANSAC,
    # so the gated check covers real loop matches
    enough = lambda out: int((out[0] >= 0).sum()) >= lc.cfg.min_pair_matches  # noqa: E731
    spans = StageTimes(torch, {"pose_graph": (pose_graph, "optimize_pose_graph"),
                               "optimize_sim3": (sim3, "optimize_sim3"),
                               "match_candidate": (lc, "_match_candidate"),
                               "correction": (lc, "_correct_loop")}, fence=False)
    reset_counts()
    frames, live, gt, waits = [], [], [], []
    try:
        with MatcherCalls(lambda dB: dB.shape[0] == win, on_loop, enough) as loop_calls, spans:
            for i, (R, t) in enumerate(poses):
                f0 = time.perf_counter()
                _, Re, te = sys_.track_features(feats[i], 0.05 * i)
                f1 = time.perf_counter()
                frames.append((f0, f1))
                if Re is not None:
                    live.append(-Re.T @ te)
                    gt.append(-R.T @ t)
                time.sleep(max(0.0, pace - (f1 - f0)))
                # the camera yields while keyframes queue for mapping
                t_bp = time.perf_counter()
                while sys_.worker.queue_size() > 1 and time.perf_counter() - t_bp < 3.0:
                    time.sleep(0.005)
                waits.append(time.perf_counter() - t_bp)
            t_fin = time.perf_counter()
            sys_.finish()  # raises a worker's exception: the phase fails
            finish_s = time.perf_counter() - t_fin
        launches, by_shape = read_counts()
        by_thread = read_thread_counts()
        store = sys_.store
        with sys_.worker.map_lock:
            check_store_invariants(store)
        rec, live_r, rec_frac = TJ.recovered_resolved(sys_.trajectory, store=store)
        rc, lr, rg = [], [], []
        for e, el in zip(rec, live_r):
            R, t = poses[int(round(e[0] / 0.05))]
            rc.append(-e[1].T @ e[2])
            lr.append(-el[1].T @ el[2])
            rg.append(-R.T @ t)
        pre = _ate(lr, rg) if len(rc) > 20 else _ate(live, gt)
        post = _ate(rc, rg) if len(rc) > 20 else float("nan")
        kf_ate = _kf_ate(store, poses)
        stats, full, aborted = dict(lc.stats), gba.full_ba_idx, gba.aborted
        loop_done, loop_skipped = sys_.loop_worker.processed, sys_.loop_worker.skipped
    finally:
        sys_.shutdown()
    ms = np.asarray([(b - a) * 1e3 for a, b in frames])

    def frames_in(t0, t1):
        """(frames that finished inside [t0, t1], the longest frame
        overlapping it, ms)."""
        inside = [i for i, (a, b) in enumerate(frames) if t0 <= b <= t1]
        over = [ms[i] for i, (a, b) in enumerate(frames) if a <= t1 and b >= t0]
        return inside, max(over, default=0.0)

    pg_windows = []
    for a, b, th in spans.spans["pose_graph"]:
        inside, longest = frames_in(a, b)
        pg_windows.append({"ms": (b - a) * 1e3, "thread": th, "frames_finished": len(inside),
                           "longest_frame_ms": longest})
    corr = [frames_in(a, b)[1] for a, b, _ in spans.spans["correction"]]
    # the first detection: the first association that reached OptimizeSim3
    first = None
    for a, b, th in spans.spans["match_candidate"]:
        if any(a <= s0 and s1 <= b for s0, s1, _ in spans.spans["optimize_sim3"]):
            first = {"ms": (b - a) * 1e3, "thread": th,
                     "longest_frame_ms": frames_in(a, b)[1], "at_s": a - frames[0][0]}
            break
    loop_shapes = by_thread.get("hfnet-loop", {})
    res = {
        "frames_tracked": len(live), "frames": len(poses), "circuit_frames": n,
        "pace_ms": pace * 1e3,
        "corrections": stats["corrected"], "detected": stats["detected"],
        "checked": stats["checked"], "loop_worker_processed": loop_done,
        "loop_worker_skipped": loop_skipped, "gba_completed": full, "gba_aborted": aborted,
        "ate_pre_m": pre, "ate_post_m": post, "ate_kf_m": kf_ate, "recovered_frac": rec_frac,
        "sync_ate_pre_m": sync["ate_pre_m"], "sync_ate_post_m": sync["ate_post_m"],
        "sync_ate_kf_m": sync["ate_kf_m"],
        "frame_ms_p50": float(np.percentile(ms[12:], 50)),
        "frame_ms_p99": float(np.percentile(ms[12:], 99)),
        "sync_frame_ms_p50": sync["frame_ms_p50"], "sync_frame_ms_p99": sync["frame_ms_p99"],
        "camera_wait_s": float(np.sum(waits)), "finish_s": finish_s,
        "first_detection": first, "sync_first_optimize_sim3_ms": sync["first_optimize_sim3_ms"],
        "pose_graph_windows": pg_windows,
        "longest_frame_during_correction_ms": max(corr, default=0.0),
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "row_top2_launches_by_thread": by_thread, "card": smi,
    }
    log("loop async: " + json.dumps(res))
    check(stats["corrected"] >= 1, f"no async loop correction ({stats})")
    check(full >= 1, f"no global BA solve completed (aborted {aborted})")
    check(np.isfinite(post), f"post-correction ATE {post} is not finite")
    check(post <= pre, f"post-correction ATE {post} m > pre-correction {pre} m")
    N, D = sys_.cfg.n_slots, sys_.cfg.desc_dim
    for shape in (f"{N},{win},{D}", f"{win},{N},{D}"):
        check(loop_shapes.get(shape, 0) >= 1,
              f"row_top2 never launched at ({shape}) from the hfnet-loop thread ({by_thread})")
    rech = recheck(torch, "async loop association", loop_calls.first, exact=True)
    check(rech["matches"] >= lc.cfg.min_pair_matches,
          f"async loop association re-checked on {rech['matches']} matches")
    return launches, by_shape, by_thread, rech, sys_


def _integrate_launches(torch, vi):
    """Kernel launches and device-synced ms of one preintegration call as a
    function of its rows, launches(n) = fixed + per_row * n, from
    torch.profiler's count of CUDA launch calls in two calls (10 and 100
    rows of the VI scene's IMU). None where the profiler saw no launch."""
    from torch.profiler import ProfilerActivity, profile

    from hfnet_slam_torch.scenes import synth_imu

    rows = synth_imu(0.0, 0.5)
    vi.integrate(rows[:10])  # warm

    def one(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vi.integrate(rows[:n])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        launch = sum(1 for x in names if "LaunchKernel" in x)
        kernels = sum(1 for e in prof.events()
                      if str(getattr(e, "device_type", "")).endswith("CUDA"))
        t0 = time.perf_counter()
        vi.integrate(rows[:n])
        torch.cuda.synchronize()
        return launch, kernels, (time.perf_counter() - t0) * 1e3

    (l10, k10, ms10), (l100, k100, ms100) = one(10), one(100)
    if l100 <= l10:
        return {"launches": "not measured (the profiler saw no CUDA launch)",
                "ms_per_row": (ms100 - ms10) / 90}
    per_row = (l100 - l10) / 90
    return {"launches_10_rows": l10, "launches_100_rows": l100,
            "device_kernels_10_rows": k10, "device_kernels_100_rows": k100,
            "launches_per_row": per_row, "launches_fixed": l10 - 10 * per_row,
            "ms_10_rows": ms10, "ms_100_rows": ms100, "ms_per_row": (ms100 - ms10) / 90}


def _vi_feeds(torch, ext, size, frames, device, dark=(), shift_at=None):
    """Per frame: features (blank in `dark`; at `shift_at` every keypoint
    40 px to the right with its descriptor kept, so the projection search
    misses and the reference keyframe's brute force matches), IMU rows and
    ground-truth centre."""
    from hfnet_slam_torch.scenes import synth_imu, vi_blank_features, vi_frame_pose, vi_pose

    blank = vi_blank_features(size).to(device)
    out = []
    for i in range(frames):
        t = i * size["frame_dt"]
        f = blank if i in dark else ext(*vi_frame_pose(t))
        if i == shift_at:
            f = f._replace(xy=f.xy + torch.tensor([40.0, 0.0], device=device))
        rows = synth_imu(t - size["frame_dt"], t, size["grav"]) if i > 0 else None
        out.append((t, f, rows, vi_pose(t)[1]))
    torch.cuda.synchronize()
    return out


def phase_vi(torch, smi):
    """bench.py's _vi_metrics scenario at production widths (VI_PRODUCTION:
    100 frames at 10 Hz, exact 200 Hz IMU), sync, loop closing off."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.geometry import imu as IMU
    from hfnet_slam_torch.optim import inertial
    from hfnet_slam_torch.scenes import VI_PRODUCTION, vi_system

    size = VI_PRODUCTION
    n = size["frames"]
    sys_, ext = vi_system(size)  # device=None: CUDA
    vi, mapper = sys_.vi, sys_.mapper
    feeds = _vi_feeds(torch, ext, size, n, sys_.device)
    integ = _integrate_launches(torch, vi)
    stages = StageTimes(torch, {
        "pose_inertial_optimize": (inertial, "pose_inertial_optimize"),
        "pose_inertial_optimize_marg": (inertial, "pose_inertial_optimize_marg"),
        "preintegration": (vi, "integrate"),
        "local_inertial_ba": (mapper, "local_inertial_ba"),
        "full_inertial_ba": (mapper, "full_inertial_ba"),
        "init_stage": (vi, "_run_stage"),
        "local_ba": (mapper, "local_ba")})
    reset_counts()
    rows0, calls0 = IMU.rows_integrated, IMU.calls
    est, gt, when, ms, vi_frames = [], [], [], [], []
    with stages:
        for i, (t, f, rows, c) in enumerate(feeds):
            f0 = time.perf_counter()
            _, Re, te = sys_.track_features(f, t, imu=rows)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - f0) * 1e3)
            if sys_.tracker._vi_active():
                vi_frames.append(i)
            if Re is not None:
                est.append(-Re.T @ te)
                gt.append(c)
                when.append(i)
    launches, by_shape = read_counts()
    rows, calls = IMU.rows_integrated - rows0, IMU.calls - calls0
    store = sys_.store
    est, gt, when, ms = np.asarray(est), np.asarray(gt), np.asarray(when), np.asarray(ms)
    check(store.imu_initialized and vi.stage >= 2, f"IMU stage {vi.stage}, want >= 2")
    late = when > 60
    check(late.sum() >= 20, f"{late.sum()} tracked frames after frame 60")
    _, _, s = ate.align_horn(est[late], gt[late], with_scale=True)
    scale_err = abs(float(s) - 1.0)
    ate_m = float(ate.ate_rmse(est[late], gt[late], with_scale=False))
    path = float(np.linalg.norm(np.diff(gt[late], axis=0), axis=1).sum())
    rep = stages.report()
    n_vi = max(len(vi_frames), 1)
    res = {
        "imu_initialized": bool(store.imu_initialized), "stage": vi.stage,
        "frames_tracked": len(est), "frames": n, "vi_frames": len(vi_frames),
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "vi_init_scale_err": scale_err, "ate_vi_metric_m": ate_m, "path_m": path,
        "reference_targets": {"vi_init_scale_err": 0.0091, "ate_vi_metric_m": 0.0662},
        "frame_ms_p50": float(np.percentile(ms[5:], 50)),
        "frame_ms_p99": float(np.percentile(ms[5:], 99)),
        "vi_frame_ms_p50": float(np.percentile(ms[vi_frames], 50)) if vi_frames else None,
        "vi_frame_ms_p99": float(np.percentile(ms[vi_frames], 99)) if vi_frames else None,
        "preintegration_rows": rows, "preintegration_calls": calls,
        "preintegration_rows_per_vi_frame": rows / n_vi,
        "preintegration_ms_per_vi_frame": rep["preintegration"]["ms"] / n_vi,
        "preintegration_cost": integ,
        "stage_ms": rep, "init_solve_s_by_stage": dict(vi.stage_seconds),
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape, "card": smi,
    }
    if isinstance(integ.get("launches_per_row"), float):
        res["preintegration_launches_per_vi_frame"] = (
            integ["launches_fixed"] * calls + integ["launches_per_row"] * rows) / n_vi
    log("vi: " + json.dumps(res))
    check(scale_err <= 0.03, f"vi_init_scale_err {scale_err} > 0.03 (BENCH_r05 0.0091)")
    check(ate_m <= 0.2, f"ate_vi_metric_m {ate_m} > 0.2 m (BENCH_r05 0.0662)")
    check(ate_m <= 0.05 * path, f"ate_vi_metric_m {ate_m} > 5% of the {path} m path")
    check(rep["pose_inertial_optimize"]["calls"] + rep["pose_inertial_optimize_marg"]["calls"]
          > 0 and rep["local_inertial_ba"]["calls"] > 0 and rep["full_inertial_ba"]["calls"] > 0,
          f"a VI stage never ran: {rep}")
    return launches, by_shape, res


def phase_vi_async(torch, smi):
    """tests/test_vi_dropout.py's async plan at production widths: its first
    80 of 90 frames at 10 Hz, frames 60-69 featureless, and at frame 45 the keypoints shifted
    40 px with their descriptors kept (the projection search misses, the
    reference keyframe's brute force matches): the first VI-path
    brute-force call with a non-empty maskA is re-checked exactly."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.scenes import VI_DROPOUT, VI_PRODUCTION, vi_system
    from hfnet_slam_torch.slam.tracking import LOST, OK, RECENTLY_LOST

    size = dict(VI_PRODUCTION, frame_dt=VI_DROPOUT["frame_dt"], grav=VI_DROPOUT["grav"])
    n, dark, shift_at = VI_BLACKOUT_FRAMES, VI_DROPOUT["blackout"], 45
    sys_, ext = vi_system(VI_PRODUCTION, async_mapping=True)  # device=None: CUDA
    feeds = _vi_feeds(torch, ext, size, n, sys_.device, dark=dark, shift_at=shift_at)
    vi_path = lambda: sys_.store.imu_initialized  # noqa: E731
    reset_counts()
    states, est, gt, when, ms = [], [], [], [], []
    try:
        with MatcherCalls(lambda dB: True, vi_path,
                          take=lambda dA, mA, dB, mB: bool(mA.any())) as calls:
            for i, (t, f, rows, c) in enumerate(feeds):
                f0 = time.perf_counter()
                st, Re, te = sys_.track_features(f, t, imu=rows)
                ms.append((time.perf_counter() - f0) * 1e3)
                states.append(st)
                if Re is not None:
                    est.append(-Re.T @ te)
                    gt.append(c)
                    when.append(i)
            sys_.finish()  # raises a worker's exception: the phase fails
        launches, by_shape = read_counts()
        by_thread = read_thread_counts()
        with sys_.worker.map_lock:
            check_store_invariants(sys_.store)
    finally:
        sys_.shutdown()
    est, gt, when = np.asarray(est), np.asarray(gt), np.asarray(when)
    pre_w = (when >= 30) & (when < 60)
    R_al, t_al, _ = ate.align_horn(est[pre_w], gt[pre_w], with_scale=False)
    dr = np.isin(when, np.arange(60, 70))
    err_dr = np.linalg.norm((R_al @ est[dr].T).T + t_al - gt[dr], axis=1)
    late = when >= 72
    err_late = float(ate.ate_rmse(est[late], gt[late], with_scale=False))
    post = states[72:]
    res = {
        "imu_initialized": bool(sys_.store.imu_initialized), "stage": sys_.vi.stage,
        "states": [int(x) for x in states], "frames_tracked": len(est), "frames": n,
        "dead_reckoning_max_err_m": float(err_dr.max()) if dr.any() else None,
        "post_recovery_metric_ate_m": err_late,
        "frame_ms_p50": float(np.percentile(ms[5:], 50)),
        "frame_ms_p99": float(np.percentile(ms[5:], 99)),
        "row_top2_launches": launches, "row_top2_launches_on_vi_path": calls.launches,
        "row_top2_launches_by_shape": by_shape, "row_top2_launches_by_thread": by_thread,
        "card": smi,
    }
    log("vi async: " + json.dumps(res))
    check(sys_.store.imu_initialized, "the staged init never ran on the mapping worker")
    check(LOST not in states, "the blackout killed the map")
    check(RECENTLY_LOST in states[60:70], "the blackout was not detected")
    check(np.mean([x == OK for x in post]) >= 0.8, f"after the blackout: {post}")
    check(all(x == OK for x in states[-6:]), f"not OK at the end: {states[-6:]}")
    check(all(i in set(when.tolist()) for i in range(61, 70)), "a blackout frame without a pose")
    check(err_dr.max() < 1.0, f"dead reckoning drifted {err_dr.max():.2f} m")
    check(err_late < 0.5, f"post-recovery metric ATE {err_late:.3f} m")
    check(calls.launches >= 2, f"row_top2 launched {calls.launches} times on the VI path")
    rech = recheck(torch, "VI reference-keyframe match", calls.first, exact=True)
    return launches, by_shape, by_thread, rech


def atlas_round_trip(sys_, path):
    """save_atlas, then load_atlas into a fresh system of the same
    capacities: every array of every map must be equal, and one flipped byte
    in a map file must make load_atlas refuse the snapshot."""
    from hfnet_slam_torch.slam.map import _ARRAY_FIELDS
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig

    sys_.save_atlas(path)
    c = sys_.cfg
    fresh = SLAMSystem(sys_.cam, None, SystemConfig(
        k_max=c.k_max, m_max=c.m_max, n_slots=c.n_slots, desc_dim=c.desc_dim,
        gdesc_dim=c.gdesc_dim, loop_closing=False))
    fresh.load_atlas(path)
    check(fresh.atlas.n_maps() == sys_.atlas.n_maps()
          and fresh.atlas.active_idx == sys_.atlas.active_idx, "atlas maps differ")
    for a, b in zip(sys_.atlas.maps, fresh.atlas.maps):
        for f in _ARRAY_FIELDS:
            check(np.array_equal(getattr(a, f), getattr(b, f)), f"atlas field {f} differs")
        check(a.loop_edges == b.loop_edges, "atlas loop edges differ")
    f0 = os.path.join(path, "map_0.npz")
    raw = bytearray(open(f0, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(f0, "wb").write(bytes(raw))
    try:
        fresh.load_atlas(path)
        refused = False
    except IOError:
        refused = True
    check(refused, "load_atlas took a snapshot with a flipped byte")
    return {"maps": sys_.atlas.n_maps(),
            "keyframes": [int(m.kf_valid.sum()) for m in sys_.atlas.maps],
            "map_points": [int(m.mp_valid.sum()) for m in sys_.atlas.maps],
            "loop_edges": [len(m.loop_edges) for m in sys_.atlas.maps],
            "arrays": "equal", "flipped_byte": "refused"}


def phase_euroc_runner(torch, smi, async_sys):
    """The EuRoC runner on a synthetic sequence, then the atlas round trip of
    its system and of phase 8's (`async_sys`, the larger map)."""
    from hfnet_slam_torch.examples import run_euroc
    from hfnet_slam_torch.scenes import write_euroc_sequence
    from hfnet_slam_torch.utils.timing import timings

    n = 40
    with tempfile.TemporaryDirectory() as tmp:
        seq, cfg, stamps = write_euroc_sequence(tmp, n)
        out = os.path.join(tmp, "traj.txt")
        timings.reset()
        printed = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with MatcherCalls(lambda dB: True) as calls, contextlib.redirect_stdout(printed):
            sys_ = run_euroc.main([seq, "--config", cfg, "--out", out])
        secs = time.perf_counter() - t0
        launches, by_shape = read_counts()
        by_thread = read_thread_counts()
        for line in printed.getvalue().splitlines():
            log(f"  run_euroc: {line}")
        report, st = timings.report(), timings.stats()
        lines = open(out).read().splitlines()
        rows = [[float(x) for x in ln.split()] for ln in lines]
        check(len(lines) == len(sys_.trajectory) >= 1,
              f"{len(lines)} TUM lines for {len(sys_.trajectory)} tracked frames")
        check(all(len(r) == 8 and np.isfinite(r).all() for r in rows), "a malformed TUM line")
        want_ts = {round(float(x), 6) for x in stamps}
        check(all(round(r[0], 6) in want_ts for r in rows), "a TUM timestamp not in the sequence")
        check("frame_total" in report and st["frame_total"][0] == n,
              "the timing report lacks frame_total")
        check(launches >= 2, f"row_top2 launched {launches} times on the runner's path, want >= 2")
        rech = recheck(torch, "euroc runner", calls.first, exact=True)

        atlas = {"euroc_runner": atlas_round_trip(sys_, os.path.join(tmp, "a1")),
                 "loop_async": atlas_round_trip(async_sys, os.path.join(tmp, "a2"))}
    store = sys_.store
    res = {
        "frames": n, "tracked_lines": len(lines), "maps": sys_.atlas.n_maps(),
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "seconds": secs, "frame_total_ms": {"n": st["frame_total"][0],
                                            "p50": st["frame_total"][3],
                                            "p95": st["frame_total"][4]},
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "row_top2_launches_by_thread": by_thread, "atlas_round_trip": atlas, "card": smi,
    }
    log("euroc runner: " + json.dumps(res))
    return launches, by_shape, rech, res


def _depth_browse(torch, smi, mode):
    """Phases 12 and 13: the browse at production widths, 120 frames with
    the 0.1 rad jolt from frame 80, through track_rgbd (RGB-D) or
    track_stereo (the rectified rig). The kernel is re-checked exactly on
    the first reference-keyframe matcher call after the jolt."""
    from hfnet_slam_torch.ops import stereo
    from hfnet_slam_torch.scenes import (PRODUCTION, STEREO_BASELINE, browse_pose, depth_image,
                                         rgbd_system, stereo_images, stereo_system)
    from hfnet_slam_torch.slam.tracking import OK

    n, jolt = 120, 80
    sys_, ext = (rgbd_system if mode == "rgbd" else stereo_system)(PRODUCTION)  # CUDA
    tr, store = sys_.tracker, sys_.store
    poses = [browse_pose(i, jolt) for i in range(n)]
    assoc = []  # stereo: (depth, left landmark ids) of each frame
    real_match = stereo.match_stereo

    def spy_match(*a, **k):
        depth, uR = real_match(*a, **k)
        assoc.append((depth.cpu().numpy(), ext.last_ids.copy()))
        return depth, uR

    made = []  # depth points created at each keyframe
    real_points = tr._create_depth_points

    def spy_points(frame, k):
        n0 = int(store.mp_valid.sum())
        real_points(frame, k)
        made.append(int(store.mp_valid.sum()) - n0)

    tr._create_depth_points = spy_points
    stereo.match_stereo = spy_match
    frame_i = [0]
    states, est, gt, ms = [], [], [], []
    torch.cuda.synchronize()
    reset_counts()
    try:
        with MatcherCalls(lambda dB: True, lambda: frame_i[0] >= jolt) as calls:
            for i, (R, t) in enumerate(poses):
                frame_i[0] = i
                if mode == "rgbd":
                    args = ((R, t), depth_image(ext.world, ext.cam, R, t, i))
                else:
                    args = stereo_images(R, t, np.eye(3), (-STEREO_BASELINE, 0.0, 0.0))
                f0 = time.perf_counter()
                st, Re, te = (sys_.track_rgbd if mode == "rgbd" else sys_.track_stereo)(
                    *args, 0.05 * i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - f0) * 1e3)
                states.append(int(st))
                if Re is not None:
                    est.append(-Re.T @ te)
                    gt.append(-R.T @ t)
    finally:
        stereo.match_stereo = real_match
        tr._create_depth_points = real_points
    launches, by_shape = read_counts()
    est, gt = np.asarray(est), np.asarray(gt)
    k0 = int(store.valid_kf_ids()[0])
    ate_m = ate_rmse(est, gt, with_scale=False)
    ate_s = ate_rmse(est, gt, with_scale=True)
    res = {
        "frames": n, "frames_tracked": len(est), "first_state": states[0],
        "first_keyframe_ts": float(store.kf_timestamp[k0]),
        "keyframes": int(store.kf_valid.sum()), "map_points": int(store.mp_valid.sum()),
        "depth_points_per_keyframe": made,
        "first_keyframe_depths": int((store.kf_depth[k0] > 0).sum()),
        "ate_metric_m": ate_m, "ate_scale_corrected_m": ate_s,
        "frame_ms_p50": float(np.percentile(ms[5:], 50)),
        "frame_ms_p99": float(np.percentile(ms[5:], 99)),
        "row_top2_launches": launches, "row_top2_launches_after_jolt": calls.launches,
        "row_top2_launches_by_shape": by_shape, "card": smi,
    }
    if mode == "stereo":
        share, rel = [], []
        for (depth, ids), (R, t) in zip(assoc, poses):
            z = (ext.world.landmarks[ids] @ R.T + t)[:, 2]
            d = depth[: len(ids)]
            share.append(float((d > 0).mean()))
            rel.append(np.abs(d[d > 0] - z[d > 0]) / z[d > 0])
        rel = np.concatenate(rel)
        res.update(match_stereo_depth_share=float(np.mean(share)),
                   match_stereo_rel_err_median=float(np.median(rel)),
                   match_stereo_rel_err_p90=float(np.percentile(rel, 90)))
    log(f"{mode}: " + json.dumps(res))
    check(np.isfinite(est).all(), "NaN/inf in the tracked poses")
    check(tr.state == OK, f"final tracking state {tr.state}, want OK")
    check(len(est) >= 105, f"{len(est)} of {n} frames tracked, want >= 105")
    check(states[0] == OK and store.kf_timestamp[k0] == 0.0,
          "the first map did not come from stereo initialization at frame 0")
    check(ate_m <= 0.25, f"metric ATE {ate_m} m > 0.25 m")
    check(ate_m <= 1.5 * ate_s + 0.05, f"metric ATE {ate_m} m > 1.5 x {ate_s} + 0.05 m")
    check(calls.launches >= 2, f"row_top2 launched {calls.launches} times after the jolt, "
          "want >= 2")
    rech = recheck(torch, f"{mode} reference-keyframe match", calls.first, exact=True)
    return launches, by_shape, rech


def saved_centres(sys_, gt_centre):
    """Camera centres of the saved trajectory (every tracked frame rebuilt
    through its reference keyframe) and the ground truth at their times."""
    from hfnet_slam_torch.utils import trajectory as TJ

    rec = TJ.recovered(sys_.trajectory)
    return (np.asarray([-np.asarray(R).T @ np.asarray(t) for _, R, t in rec]),
            np.asarray([gt_centre(ts)[1] for ts, _, _ in rec]))


def phase_rig(torch, smi):
    """Phase 14: the KB8 fisheye rig (cam_right and T_lr set) at production
    widths, 60 frames through track_stereo: right-bank observations at every
    keyframe track_stereo creates and ToBody edges in every local BA."""
    from hfnet_slam_torch.scenes import RIG_PRODUCTION, rig_pose, rig_system, stereo_images

    size = RIG_PRODUCTION
    sys_, _, (R_rl, t_rl) = rig_system(size)  # CUDA
    mapper, store = sys_.mapper, sys_.store
    right_edges, real = [], mapper._right_edges

    def spy(*a, **k):
        out = real(*a, **k)
        right_edges.append((mapper.stats["right_edges"], mapper.stats["right_edges_dropped"]))
        return out

    mapper._right_edges = spy
    stages = StageTimes(torch, {"local_ba": (mapper, "local_ba")}, fence=False)
    est, gt, ms, bank = [], [], [], {}
    torch.cuda.synchronize()
    reset_counts()
    try:
        with stages:
            for i in range(size["frames"]):
                R, t = rig_pose(i, size["step"])
                f0 = time.perf_counter()
                _, Re, te = sys_.track_stereo(*stereo_images(R, t, R_rl, t_rl), 0.1 * i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - f0) * 1e3)
                if Re is not None:
                    est.append(-Re.T @ te)
                    gt.append(-R.T @ t)
                for k in store.valid_kf_ids():
                    bank.setdefault(int(store.kf_uid[k]), int((store.kf_obs_r[k] >= 0).sum()))
    finally:
        mapper._right_edges = real
    launches, by_shape = read_counts()
    ate_m = ate_rmse(est, gt, with_scale=False)
    n_ba = len(stages.ms["local_ba"])
    res = {"frames": size["frames"], "frames_tracked": len(est),
           "keyframes": int(store.kf_valid.sum()), "ate_metric_m": ate_m,
           "right_bank_by_keyframe": bank, "local_ba_calls": n_ba,
           "right_edges_by_local_ba": [e for e, _ in right_edges],
           "right_edges_dropped_by_local_ba": [d for _, d in right_edges],
           "frame_ms_p50": float(np.percentile(ms[5:], 50)),
           "frame_ms_p99": float(np.percentile(ms[5:], 99)),
           "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape, "card": smi}
    log("rig: " + json.dumps(res))
    check(np.isfinite(np.asarray(est)).all(), "NaN/inf in the tracked poses")
    check(ate_m < 0.08, f"metric ATE {ate_m} m >= 0.08 m")
    # the first keyframe comes from stereo initialization, which stores no
    # right observations in either package; track_stereo makes the others
    later = [v for u, v in sorted(bank.items())[1:]]
    check(len(later) >= 1 and all(v > 0 for v in later),
          f"a keyframe without right-bank observations: {bank}")
    check(n_ba >= 1 and len(right_edges) == n_ba and all(e > 0 for e, _ in right_edges),
          f"a local BA without right-camera edges: {right_edges} over {n_ba} calls")
    return launches, by_shape


def phase_stereo_vi(torch, smi):
    """Phase 15: the VI scene at production widths with a rectified right
    camera 0.11 m along x, its first STEREO_VI_FRAMES frames at 10 Hz through
    track_stereo_inertial. The metric ATE is that of the saved trajectory
    (every tracked frame rebuilt through its reference keyframe in the final
    map): the IMU initialization rotates the world to gravity, so track-time
    poses from before and after it lie in different frames."""
    from hfnet_slam_torch.scenes import (VI_BASELINE, VI_PRODUCTION, stereo_images,
                                         stereo_vi_system, synth_imu, vi_frame_pose, vi_pose)

    size, n = VI_PRODUCTION, STEREO_VI_FRAMES
    sys_, _ = stereo_vi_system(size)  # CUDA
    feeds = []
    for i in range(n):
        t = i * size["frame_dt"]
        rows = synth_imu(t - size["frame_dt"], t, size["grav"]) if i > 0 else None
        feeds.append((t, stereo_images(*vi_frame_pose(t), np.eye(3), (-VI_BASELINE, 0.0, 0.0)),
                      rows, vi_pose(t)[1]))
    torch.cuda.synchronize()
    reset_counts()
    states, est, gt, ms, vi_frames = [], [], [], [], []
    for i, (t, images, rows, c) in enumerate(feeds):
        f0 = time.perf_counter()
        st, Re, te = sys_.track_stereo_inertial(*images, t, rows)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - f0) * 1e3)
        states.append(int(st))
        if sys_.tracker._vi_active():
            vi_frames.append(i)
        if Re is not None:
            est.append(-Re.T @ te)
            gt.append(c)
    launches, by_shape = read_counts()
    est, gt, ms = np.asarray(est), np.asarray(gt), np.asarray(ms)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    rec_c, rec_g = saved_centres(sys_, vi_pose)
    ate_m = ate_rmse(rec_c, rec_g, with_scale=False)
    res = {"frames": n, "frames_tracked": len(est), "first_state": states[0],
           "imu_initialized": bool(sys_.store.imu_initialized), "stage": sys_.vi.stage,
           "keyframes": int(sys_.store.kf_valid.sum()), "vi_frames": len(vi_frames),
           "ate_metric_m": ate_m, "path_m": path,
           "ate_scale_corrected_m": ate_rmse(rec_c, rec_g, with_scale=True),
           "ate_metric_track_time_after_init_m":
               ate_rmse(est[vi_frames], gt[vi_frames], with_scale=False)
               if len(vi_frames) > 3 and len(est) == n else None,
           "frame_ms_p50": float(np.percentile(ms[5:], 50)),
           "frame_ms_p99": float(np.percentile(ms[5:], 99)),
           "vi_frame_ms_p50": float(np.percentile(ms[vi_frames], 50)) if vi_frames else None,
           "vi_frame_ms_p99": float(np.percentile(ms[vi_frames], 99)) if vi_frames else None,
           "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape, "card": smi}
    log("stereo vi: " + json.dumps(res))
    check(np.isfinite(est).all(), "NaN/inf in the tracked poses")
    check(states[0] == 1, "stereo depth did not initialize the map at frame 0")
    check(sys_.store.imu_initialized and sys_.vi.stage >= 1, f"IMU stage {sys_.vi.stage}")
    check(ate_m <= 0.2, f"metric ATE {ate_m} m > 0.2 m")
    check(ate_m <= 0.05 * path, f"metric ATE {ate_m} m > 5% of the {path} m path")
    return launches, by_shape


def phase_tum_rgbd_runner(torch, smi):
    """Phase 16: examples/run_tum_rgbd on a 40-frame synthetic TUM RGB-D
    sequence (HF-Net with seeded random weights at full width): one TUM line
    per tracked frame, and the first keyframe's depths are the written
    plane's in metres (the depth map factor applied once)."""
    from hfnet_slam_torch.examples import run_tum_rgbd
    from hfnet_slam_torch.scenes import tum_plane_depth, write_tum_rgbd_sequence
    from hfnet_slam_torch.utils.timing import timings

    n = 40
    with tempfile.TemporaryDirectory() as tmp:
        seq, cfg, stamps = write_tum_rgbd_sequence(tmp, n)
        out = os.path.join(tmp, "traj.txt")
        timings.reset()
        printed = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            sys_ = run_tum_rgbd.main([seq, "--config", cfg, "--out", out])
        secs = time.perf_counter() - t0
        launches, by_shape = read_counts()
        for line in printed.getvalue().splitlines():
            log(f"  run_tum_rgbd: {line}")
        st = timings.stats()
        lines = open(out).read().splitlines()
    store = sys_.store
    k0 = int(store.valid_kf_ids()[0])
    d = store.kf_depth[k0]
    med, want = float(np.median(d[d > 0])), float(np.median(tum_plane_depth(480, 640)))
    res = {"frames": n, "tracked_lines": len(lines), "keyframes": int(store.kf_valid.sum()),
           "first_keyframe_median_depth_m": med, "written_median_depth_m": want,
           "seconds": secs, "extract_ms_p50": st["extract"][3],
           "frame_total_ms_p50": st["frame_total"][3],
           "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape, "card": smi}
    log("tum rgbd runner: " + json.dumps(res))
    check(sys_.device.type == "cuda" and sys_.cfg.depth_factor == 1.0,
          "the runner is not on the card or scales depth twice")
    check(len(lines) == len(sys_.trajectory) >= 1,
          f"{len(lines)} TUM lines for {len(sys_.trajectory)} tracked frames")
    check(store.kf_timestamp[k0] == float(stamps[0]), "the map did not start at frame 0")
    check(abs(med - want) <= 0.02 * want, f"first keyframe median depth {med} m, written {want}")
    check(st["frame_total"][0] == n and st["extract"][0] == n, "the timing report is short")
    return launches, by_shape


def phases_stereo(torch, smi):
    """Phases 12-16, each with its launch counts zeroed just before its path
    and read just after: launches and shapes by path, the re-checks, and
    each phase's seconds."""
    out = {"launches": {}, "shapes": {}, "rechecks": [], "seconds": {}}
    for name, run in (("rgbd", lambda: _depth_browse(torch, smi, "rgbd")),
                      ("stereo", lambda: _depth_browse(torch, smi, "stereo")),
                      ("rig", lambda: phase_rig(torch, smi)),
                      ("stereo_vi", lambda: phase_stereo_vi(torch, smi)),
                      ("tum_rgbd_runner", lambda: phase_tum_rgbd_runner(torch, smi))):
        t0 = time.perf_counter()
        launches, shapes, *rech = run()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name], out["shapes"][name] = launches, shapes
        out["rechecks"].extend(rech)
    return out


# ---------------------------------------------------------------------------
# CNN in the loop (phase 17) and the mesh layer (phase 18)
# ---------------------------------------------------------------------------

ATE_CNN_REFERENCE_M = 0.7836  # BENCH_r05: the reference's ate_cnn_m on an 8.74 m path
# the mesh routes agree as tests/test_torch_parallel.py holds them (TOL_MESH)
TOL_MESH_M = 2e-3


def _train_step_profile(torch, world, n=20):
    """One self-training step on the card (two 640x480 views, 192 pairs,
    descriptors only, bench.py's recipe) from the seed-0 net: CUDA-event ms
    of the whole step over n steps and of its forward, backward and Adam
    update, device ms and kernel count of one step under torch.profiler,
    and its bound: 3 x the forward FLOPs (forward, then the backward's two
    products per layer) of both views at the float32 peak."""
    from hfnet_slam_torch.models import selftrain as ST
    from hfnet_slam_torch.tools import extract_breakdown as XB
    from hfnet_slam_torch.tools.peaks import H100_BYTES_PER_S, H100_FP32_FLOPS

    net = ST.trainable_copy(ST.init_net())  # device=None: CUDA
    dev = next(net.parameters()).device
    opt = ST.make_optimizer(net, 1e-3)
    pa, pb = world.orbit_pose(0), world.orbit_pose(4)
    (ia, da), (ib, _) = world.render_rgbd(*pa), world.render_rgbd(*pb)
    ua, ub = world.correspondences(pa, pb, da, 256, np.random.default_rng(0))
    H, W = da.shape
    t = [torch.as_tensor(x, device=dev) for x in (ia, ib, ua[:192], ub[:192])]
    tgt = torch.zeros((H // 8, W // 8), dtype=torch.int64, device=dev)
    args = (t[0], t[1], t[2], t[3], tgt, tgt, (H, W), 0.0)

    def step():
        return ST.train_step(net, opt, *args)

    for _ in range(3):
        step()
    ms = _events_ms(torch, lambda: [step() for _ in range(n)], n)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    for e in ev:
        e[0].record()
        opt.zero_grad(set_to_none=True)
        loss = ST.loss_fn(net, *args)
        e[1].record()
        loss.backward()
        e[2].record()
        opt.step()
        e[3].record()
    torch.cuda.synchronize()
    split = {name: float(np.mean([e[i].elapsed_time(e[i + 1]) for e in ev]))
             for i, name in enumerate(("forward_ms", "backward_ms", "adam_ms"))}
    dev_ms, kernels = XB._profile(step)
    c = XB.forward_cost(H, W, False)
    h8, w8 = H // 8, W // 8
    det_flops = 2.0 * h8 * w8 * 128 * 9 * 128 + 2.0 * h8 * w8 * 65 * 128  # not run here
    fwd = c["flops"] - det_flops
    flops = 2 * 3 * fwd
    n_params = sum(p.numel() for p in ST.local_parameters(net))
    # bytes: both images and the pairs read; each local parameter, its
    # gradient and Adam's two moments read and the parameter and moments
    # written once
    nbytes = 4.0 * (2 * H * W + 4 * 192) + 4.0 * 7 * n_params
    t_ops, t_bytes = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    b, by = XB.bound(t_ops, t_bytes)
    return {"ms": ms, **split, "device_ms": dev_ms, "kernels": kernels,
            "gflop": flops / 1e9, "local_params": n_params, "bound_ms": b, "bound_by": by,
            "bound_share": b / ms}


def _true_match_share(torch, world, ext, i, j, tol=3.0):
    """Frames i and j through `ext` and the gated mutual matcher
    (match_descriptors_fused, row_top2 both ways): the share of mutual
    matches within `tol` px of where the world's exact geometry sends the
    keypoint of frame i (its depth at the nearest pixel), and the inputs."""
    from hfnet_slam_torch.ops import bf_match as B

    (pa, pb) = world.orbit_pose(i), world.orbit_pose(j)
    (ia, da), (ib, _) = world.render_rgbd(*pa), world.render_rgbd(*pb)
    fa, fb = ext(ia), ext(ib)
    idx, _ = B.match_descriptors_fused(fa.desc, fa.mask, fb.desc, fb.mask)
    hit = (idx >= 0).cpu().numpy()
    xa = fa.xy.cpu().numpy()[hit]
    xb = fb.xy.cpu().numpy()[idx.cpu().numpy()[hit]]
    H, W = da.shape
    u = np.clip(np.round(xa[:, 0]).astype(int), 0, W - 1)
    v = np.clip(np.round(xa[:, 1]).astype(int), 0, H - 1)
    z = da[v, u]
    px = world.cam.params.cpu().numpy()
    pc = np.stack([(xa[:, 0] - px[2]) / px[0] * z, (xa[:, 1] - px[3]) / px[1] * z, z], 1)
    pcb = ((pc - pa[1]) @ pa[0]) @ pb[0].T + pb[1]
    true_b = world._project(pcb)
    near = np.linalg.norm(true_b - xb, axis=1) <= tol
    share = float(near.mean()) if len(near) else 0.0
    return {"mutual_matches": int(hit.sum()), "within_3px": int(near.sum()),
            "share_within_3px": share}, (fa.desc, fa.mask, fb.desc, fb.mask)


def phase_cnn(torch, smi):
    """bench.py's CNN-in-the-loop run at production size on the card."""
    from hfnet_slam_torch.models import selftrain as ST
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.scenes import CNN_PRODUCTION, cnn_run, cnn_system

    size = CNN_PRODUCTION
    t0 = time.perf_counter()
    sys_, world, tstats = cnn_system(size)  # device=None: CUDA; trains on the card
    build_s = time.perf_counter() - t0
    losses = tstats.pop("losses")
    check(np.isfinite(losses).all(), "a non-finite training loss")
    step = _train_step_profile(torch, world)

    # the mapping queue at each keyframe decision and the mapper's ms per
    # keyframe beside the tracker's ms per frame (ROADMAP Queue 3 (f))
    decisions = []
    tracker = sys_.tracker
    need_kf = tracker._need_new_keyframe

    def need(frame):
        queued = sys_.worker.queue_size()
        out = need_kf(frame)
        decisions.append((queued, bool(out)))
        return out

    tracker._need_new_keyframe = need
    reset_counts()  # count only the 120-frame run's launches
    with StageTimes(torch, {"mapper_keyframe": (sys_.mapper, "process_keyframe"),
                            "track_frame": (sys_, "track_features")}, fence=False) as st:
        run = cnn_run(sys_, world, size["frames"])
    launches, by_shape = read_counts()
    del tracker._need_new_keyframe
    pace = {
        "queue_at_decision": [q for q, _ in decisions],
        "queue_at_keyframe": [q for q, k in decisions if k],
        "decisions": len(decisions), "keyframes_made": sum(k for _, k in decisions),
        "mapper_keyframe_ms": {"n": len(st.ms["mapper_keyframe"]),
                               "p50": float(np.percentile(st.ms["mapper_keyframe"], 50)),
                               "mean": float(np.mean(st.ms["mapper_keyframe"]))},
        "track_frame_ms": {"n": len(st.ms["track_frame"]),
                           "p50": float(np.percentile(st.ms["track_frame"], 50)),
                           "mean": float(np.mean(st.ms["track_frame"]))},
    }
    check(pace["mapper_keyframe_ms"]["n"] >= 1 and pace["track_frame_ms"]["n"] == size["frames"],
          f"phase 17's pace counters saw {pace['mapper_keyframe_ms']['n']} keyframes and "
          f"{pace['track_frame_ms']['n']} frames")
    states = run.pop("states")
    inliers = run.pop("inliers")
    est_ok = "ate_cnn_m" in run
    sys_.shutdown()

    # the matcher called directly on two frames: the trained net and the
    # seed-0 net at the same extractor settings (not main-path launches)
    ext = sys_.extractor
    reset_counts()
    trained, captured = _true_match_share(torch, world, ext, 0, 4)
    seed0_ext = HFExtractor(ST.init_net(), ext.image_hw, n_features=size["n_features"],
                            n_levels=size["n_levels"], pad_to=size["pad_to"], threshold=0.003)
    seed0, _ = _true_match_share(torch, world, seed0_ext, 0, 4)
    n_call, shapes_call = read_counts()
    check(bool(captured[1].any()), "frame 0 has no valid keypoint (maskA empty)")
    rech = recheck(torch, "cnn trained descriptors", (captured, {}), exact=True)

    res = {
        "cnn_train_s": tstats["train_s"], "cnn_train_loss": tstats["loss_last"],
        "loss_first": tstats["loss_first"], "loss_last": tstats["loss_last"],
        "train_steps": tstats["steps"], "system_build_s": build_s,
        **run,
        "ate_cnn_reference_m": ATE_CNN_REFERENCE_M,
        "reference_tpu_figures": {"cnn_e2e_fps": 5.22, "cnn_train_s": 36.2,
                                  "note": "BENCH_r05, the JAX reference on a TPU"},
        "train_step": step, "states": states, "inliers": inliers,
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "matcher_trained": trained, "matcher_seed0": seed0,
        "matcher_call_launches": n_call, "pace": pace, "card": smi,
    }
    log("cnn: " + json.dumps(res))
    check(run["cnn_lost"] == 0, f"{run['cnn_lost']} frames LOST")
    check(run["cnn_tracked_frac"] >= 0.9, f"tracked share {run['cnn_tracked_frac']} < 0.9")
    check(run["cnn_kf_count"] >= 3, f"{run['cnn_kf_count']} keyframes, want >= 3")
    check(est_ok, "20 or fewer frames tracked: no ATE")
    check(run["ate_cnn_m"] < 0.35 * run["cnn_path_m"],
          f"ATE {run['ate_cnn_m']} m >= 0.35 x the {run['cnn_path_m']} m path")
    check(tstats["loss_last"] < 0.6 * tstats["loss_first"],
          f"training loss {tstats['loss_last']} >= 0.6 x {tstats['loss_first']}")
    return launches, by_shape, n_call, shapes_call, rech, res


def _map_cost(torch, store, cam, edges):
    """Huber-robust reprojection cost (chi2 5.991) of fixed edges (kf, slot,
    mp, uv, inv_sigma2) at the store's current poses and points."""
    from hfnet_slam_torch.optim import factors

    kf, mp, uv, inv_s2 = edges
    dev = cam.params.device
    R = torch.tensor(store.kf_R[kf], device=dev)
    t = torch.tensor(store.kf_t[kf], device=dev)
    p = torch.tensor(store.mp_pos[mp], device=dev)
    pc = (R @ p[..., None])[..., 0] + t
    chi2 = torch.sum((cam.project(pc) - torch.tensor(uv, device=dev)) ** 2, -1) * \
        torch.tensor(inv_s2, device=dev)
    d2 = factors.CHI2_MONO
    rob = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=0.0)) - d2)
    return float(torch.where(pc[:, 2] > 0, rob, 0.0).sum())


def phase_mesh(torch, smi, loop_sys):
    """Global BA of phase 5's final map three ways (the single solver sized
    to the map, the distributed solver on the one-shard default mesh, on a
    4-shard mesh on the one card), then install_mesh and one retrieval."""
    from hfnet_slam_torch.parallel import dist_ba as DBA
    from hfnet_slam_torch.parallel.multihost import make_mesh
    from hfnet_slam_torch.slam import retrieval as SR
    from hfnet_slam_torch.slam.local_mapping import LocalMapper
    from hfnet_slam_torch.slam.map import MapStore

    cfg = loop_sys.cfg
    rounds = cfg.loop.gba_rounds
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop_map.npz")
        loop_sys.store.save(path)
        stores = [MapStore.load(path) for _ in range(3)]
    s0 = stores[0]
    kf_ids = s0.valid_kf_ids()
    anchor = int(kf_ids[0])
    kf_e, slot_e, mp_e = s0.observing_slots(np.nonzero(s0.mp_valid)[0])
    keep = s0.kf_valid[kf_e]
    kf_e, slot_e, mp_e = kf_e[keep], slot_e[keep], mp_e[keep]
    edges = (kf_e, mp_e, s0.kf_xy[kf_e, slot_e],
             (1.0 / (1.2 ** (2.0 * s0.kf_octave[kf_e, slot_e]))).astype(np.float32))
    cam = loop_sys.cam
    cost0 = _map_cost(torch, s0, cam, edges)
    n_mp, n_obs = int(s0.mp_valid.sum()), len(kf_e)

    seen_costs = []
    real = DBA.dist_bundle_adjust

    def spy(*a, **k):
        out = real(*a, **k)
        seen_costs.append(out[2])
        return out

    reset_counts()
    routes = {}
    DBA.dist_bundle_adjust = spy
    try:
        for name, store in zip(("single", "dist_1", "dist_4"), stores):
            m = LocalMapper(cam, store, cfg.mapper)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "single":  # the port's route before this slice
                caps = tuple(1 << max(lo, int(n - 1).bit_length())
                             for n, lo in ((len(kf_ids), 3), (n_mp, 4), (n_obs, 6)))
                m._run_ba(list(kf_ids), fixed_ids={anchor}, rounds=rounds, kf_cap=caps[0],
                          mp_cap=caps[1], edge_cap=caps[2])
            else:
                if name == "dist_4":
                    m.mesh = make_mesh("ba", n_local=4)  # device=None: CUDA
                m.run_global_ba(fixed_ids=[anchor], rounds=rounds)  # past ba_kf_cap
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            iters = sum(n for n, _ in rounds) if name == "single" else len(seen_costs[-1]) - 1
            routes[name] = {"cost": _map_cost(torch, store, cam, edges), "iterations": iters,
                            "ms": ms, "dist_gba": m.stats.get("dist_gba", 0),
                            "map_points_after": int(store.mp_valid.sum())}
    finally:
        DBA.dist_bundle_adjust = real

    def centres(s):
        return np.einsum("kji,kj->ki", s.kf_R[kf_ids], -s.kf_t[kf_ids])

    mesh_dev = float(np.linalg.norm(centres(stores[1]) - centres(stores[2]), axis=1).max())

    # install_mesh on a 4-shard mesh and one retrieval, against the unmeshed scan
    store = loop_sys.store
    q = store.kf_gdesc[int(kf_ids[len(kf_ids) // 2])].copy()
    plain = SR.score_all(store, q)
    cand_plain = SR.detect_n_best_candidates(store, q, exclude=[int(kf_ids[len(kf_ids) // 2])])
    loop_sys.install_mesh(make_mesh("ba", n_local=4))
    meshed = SR.score_all(store, q)
    cand_mesh = SR.detect_n_best_candidates(store, q, exclude=[int(kf_ids[len(kf_ids) // 2])])
    launches, by_shape = read_counts()
    score_err = float(np.abs(meshed - plain).max())
    res = {"keyframes": len(kf_ids), "map_points": n_mp, "edges": n_obs,
           "cost_before": cost0, "routes": routes, "dist_1_vs_4_centre_max_m": mesh_dev,
           "retrieval": {"score_max_abs_err": score_err, "candidates_plain": cand_plain,
                         "candidates_meshed": cand_mesh,
                         "cache_built": getattr(store, "_retrieval_cache", None) is not None},
           "row_top2_launches": launches, "nccl_across_cards": "not verified (one card)",
           "card": smi}
    log("mesh: " + json.dumps(res))
    check(routes["dist_1"]["dist_gba"] >= 1, "the one-shard route did not count dist_gba")
    check(routes["dist_4"]["dist_gba"] >= 1, "the 4-shard route did not count dist_gba")
    check(all(np.isfinite(r["cost"]) for r in routes.values()), "a non-finite route cost")
    check(routes["dist_1"]["cost"] <= routes["single"]["cost"] * 1.001,
          f"dist route cost {routes['dist_1']['cost']} > 1.001 x the single solver's "
          f"{routes['single']['cost']}")
    check(mesh_dev <= TOL_MESH_M, f"1- and 4-shard routes {mesh_dev} m apart > {TOL_MESH_M}")
    check(score_err <= 1e-6 and cand_mesh == cand_plain, "meshed retrieval differs")
    check(res["retrieval"]["cache_built"], "the sharded retrieval table was not built")
    return launches, by_shape, res


# ---------------------------------------------------------------------------
# the live frontends (phase 19)
# ---------------------------------------------------------------------------

STREAM_FRAMES = 40
# examples/run_synthetic.py --scene corridor --frames 80, the JAX reference on
# the CPU: 43 frames tracked, scale-corrected ATE 0.0018556765991241207 m
CORRIDOR_REFERENCE = (43, 0.0018556765991241207)


def _http(url, payload=None, origin=None, timeout=10):
    """GET (payload None) or POST a JSON payload: (status, body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=None if payload is None else
                                 json.dumps(payload).encode(),
                                 method="GET" if payload is None else "POST")
    if origin is not None:
        req.add_header("Origin", origin)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_stream(torch, smi, euroc_frame_ms=None):
    """The socket stream server on phase 9's synthetic EuRoC sequence (HF-Net
    at 752x480, seed-0 weights, async mapping) through run_stream's
    --settings path, with the web viewer and its step gate; then
    run_synthetic's corridor scene."""
    from hfnet_slam_torch.examples import run_stream, run_synthetic
    from hfnet_slam_torch.scenes import write_euroc_sequence
    from hfnet_slam_torch.slam.tracking import _STATE_NAMES
    from hfnet_slam_torch.utils.datasets import load_euroc
    from hfnet_slam_torch.utils.stream import SLAMStreamServer, StreamClient

    n = STREAM_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir, cfg, stamps = write_euroc_sequence(tmp, n)
        seq = load_euroc(seq_dir)
        images = [np.round(seq.image(i)).astype(np.uint8) for i in range(n)]
        sys_ = run_stream.build_system(run_stream.parse_args(["--settings", cfg]))
    check(sys_.device.type == "cuda" and sys_.worker is not None,
          "run_stream's --settings system is not the async card system")
    server = SLAMStreamServer(sys_, port=0)
    viewer = sys_.start_webviewer(min_period=0)
    cli = StreamClient(*server.address, timeout=600.0)
    answers, trip_ms = [], []
    torch.cuda.synchronize()
    reset_counts()
    with MatcherCalls(lambda dB: True) as calls:
        for i in range(n):
            t0 = time.perf_counter()
            answers.append(cli.send_image(images[i], float(stamps[i])))
            trip_ms.append((time.perf_counter() - t0) * 1e3)
    launches, by_shape = read_counts()
    by_thread = read_thread_counts()
    on_handler = sum(v for name, shapes in by_thread.items()
                     if "process_request_thread" in name for v in shapes.values())
    sys_.finish()

    check(len(answers) == n, f"{len(answers)} answers for {n} frames")
    check(all(a["state"] in _STATE_NAMES.values() for a in answers),
          f"an unknown state: {sorted({a['state'] for a in answers})}")
    posed = [a for a in answers if a["R"] is not None]
    traj = {round(e.ts, 6): e for e in sys_.tracker.trajectory}
    check(len(posed) == len(sys_.tracker.trajectory) >= 1,
          f"{len(posed)} answers with a pose, {len(sys_.tracker.trajectory)} trajectory entries")
    for a in posed:
        e = traj.get(round(a["ts"], 6))
        check(e is not None and np.array_equal(np.asarray(a["R"]),
                                               np.round(e.R.astype(np.float64), 6))
              and np.array_equal(np.asarray(a["t"]), np.round(e.t.astype(np.float64), 6)),
              f"the answer at ts {a['ts']} is not the trajectory's pose")
    check(on_handler >= 2, f"row_top2 launched {on_handler} times on the server's handler "
          f"thread, want >= 2 ({by_thread})")
    rech = recheck(torch, "stream server", calls.first, exact=True)

    viewer.publish(sys_.store, sys_.tracker)
    code, body = _http(viewer.url + "state.json")
    state = json.loads(body)
    n_kf = int(sys_.store.kf_valid.sum())
    check(code == 200 and state["frames"] == n and state["n_kf"] == n_kf,
          f"viewer state frames {state.get('frames')} n_kf {state.get('n_kf')}, "
          f"want {n} and {n_kf}")

    # the step gate: a frame sent with the gate armed gets no answer until a
    # step is posted
    check(_http(viewer.url + "control", {"cmd": "step_mode", "on": True})[0] == 200,
          "step_mode refused")
    got = []
    gated = threading.Thread(target=lambda: got.append(
        cli.send_image(images[-1], float(stamps[-1]) + 0.05)), daemon=True)
    t_sent = time.perf_counter()
    gated.start()
    gated.join(timeout=1.0)
    check(not got, "a frame was answered while the step gate was armed")
    check(_http(viewer.url + "control", {"cmd": "step"})[0] == 200, "step refused")
    gated.join(timeout=30.0)
    gate_ms = (time.perf_counter() - t_sent) * 1e3
    check(len(got) == 1, "no answer within 30 s of the step")
    foreign = _http(viewer.url + "control", {"cmd": "release"}, origin="http://example.com")[0]
    check(foreign == 403, f"a cross-origin POST got {foreign}, want 403")
    viewer.release()
    cli.close()
    server.close()
    sys_.shutdown()
    check(not viewer._thread.is_alive(), "the viewer thread outlived shutdown")

    # the monocular main path's example on its corridor scene
    printed = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        corridor = run_synthetic.main(["--scene", "corridor", "--frames", "80"])
    corridor_s = time.perf_counter() - t0
    n_corr, shapes_corr = read_counts()
    for line in printed.getvalue().splitlines():
        log(f"  run_synthetic: {line}")

    res = {
        "frames": n, "answers_with_pose": len(posed), "keyframes": n_kf,
        "map_points": int(sys_.store.mp_valid.sum()),
        "states": [a["state"] for a in answers],
        "round_trip_ms": {"p50": float(np.percentile(trip_ms, 50)),
                          "p99": float(np.percentile(trip_ms, 99)),
                          "p50_from_frame_5": float(np.percentile(trip_ms[5:], 50)),
                          "first": trip_ms[0], "each": trip_ms},
        "euroc_runner_frame_total_ms": euroc_frame_ms,
        "gate_answer_ms": gate_ms, "viewer_state": {k: state[k] for k in ("frames", "n_kf",
                                                                          "n_mp", "state")},
        "row_top2_launches": launches, "row_top2_launches_by_shape": by_shape,
        "row_top2_launches_by_thread": by_thread, "on_handler_thread": on_handler,
        "corridor": {**corridor, "seconds": corridor_s, "reference": CORRIDOR_REFERENCE,
                     "row_top2_launches": n_corr},
        "card": smi,
    }
    log("stream: " + json.dumps(res))
    ref_n, ref_ate = CORRIDOR_REFERENCE
    check(corridor["ate_m"] is not None and abs(corridor["tracked"] - ref_n) <= 2,
          f"corridor tracked {corridor['tracked']} of 80, the reference {ref_n}")
    check(corridor["ate_m"] <= max(2 * ref_ate, 0.01),
          f"corridor ATE {corridor['ate_m']} m > max(2 x {ref_ate}, 0.01)")
    return launches, by_shape, by_thread, rech, n_corr, shapes_corr


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="chip smoke test of the port (one GPU)")
    ap.add_argument("--only", choices=("kernel", "vi", "stereo", "cnn", "mesh", "stream"),
                    help="run phases 1-3 (with 'vi' also phases 10-11, with 'stereo' phases "
                    "12-16, with 'cnn' phase 17, with 'mesh' phases 5 and 18, with 'stream' "
                    "phase 19) and stop, without the result lines")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import hfnet_slam_torch  # noqa: F401  (fails here when run without the repository)

    smi = phase_environment(torch)
    phase_build()
    max_err, timings = phase_kernel(torch)
    if args.only == "vi":
        phase_vi(torch, smi)
        phase_vi_async(torch, smi)
    if args.only == "stereo":
        phases_stereo(torch, smi)
    if args.only == "cnn":
        phase_cnn(torch, smi)
    if args.only == "mesh":
        phase_mesh(torch, smi, phase_loop(torch, smi)[4])
    if args.only == "stream":
        phase_stream(torch, smi)
    if args.only:
        log(f"chip_smoke: --only {args.only}: those phases passed; no result printed")
        return 0
    t0 = time.perf_counter()
    n_browse, shapes_browse = phase_slice(torch, smi)
    t1 = time.perf_counter()
    n_loop, shapes_loop, rech_loop, loop_res, loop_sys = phase_loop(torch, smi)
    t2 = time.perf_counter()
    n_reloc, shapes_reloc, rech_reloc, n_reloc_calls = phase_reloc(torch, smi)
    t3 = time.perf_counter()
    (n_track, shapes_track, rech_track), (n_call, shapes_call, rech_call) = \
        phase_extraction(torch, smi)
    t4 = time.perf_counter()
    n_async, shapes_async, threads_async, rech_async, async_sys = \
        phase_loop_async(torch, smi, loop_res)
    t5 = time.perf_counter()
    n_euroc, shapes_euroc, rech_euroc, euroc_res = phase_euroc_runner(torch, smi, async_sys)
    t6 = time.perf_counter()
    n_vi, shapes_vi, _ = phase_vi(torch, smi)
    t7 = time.perf_counter()
    n_via, shapes_via, threads_via, rech_via = phase_vi_async(torch, smi)
    t8 = time.perf_counter()
    depth = phases_stereo(torch, smi)
    t9 = time.perf_counter()
    n_cnn, shapes_cnn, n_cnn_call, shapes_cnn_call, rech_cnn, _ = phase_cnn(torch, smi)
    t10 = time.perf_counter()
    n_mesh, shapes_mesh, _ = phase_mesh(torch, smi, loop_sys)
    t11 = time.perf_counter()
    n_stream, shapes_stream, threads_stream, rech_stream, n_corr, shapes_corr = phase_stream(
        torch, smi, euroc_res["frame_total_ms"])
    log(f"phase seconds: browse {t1 - t0:.1f}, loop {t2 - t1:.1f}, "
        f"relocalization {t3 - t2:.1f}, extraction {t4 - t3:.1f}, loop async {t5 - t4:.1f}, "
        f"euroc runner {t6 - t5:.1f}, vi {t7 - t6:.1f}, vi async {t8 - t7:.1f}, "
        + ", ".join(f"{k} {v:.1f}" for k, v in depth["seconds"].items())
        + f", cnn {t10 - t9:.1f}, mesh {t11 - t10:.1f}, stream {time.perf_counter() - t11:.1f}"
        + f"; phases 4-19 {time.perf_counter() - t0:.1f}")

    # the browse shape leads; the loop-association shapes follow under
    # "shapes". Paths are main-path runs; "relocalization_calls" is the part
    # of the relocalization count made inside relocalization, and
    # "extraction_matcher_call" phase 7's direct search_brute_force call on
    # two frames, which is not a main-path run and not in "launches"; "cnn"
    # is phase 17's 120-frame run, "cnn_matcher_call" its direct calls on
    # two frames' descriptors (not in "launches"), "mesh" phase 18's
    # global BAs and retrieval, "stream" phase 19's 40 frames through the
    # socket server and "synthetic_corridor" its run_synthetic run
    kern = {
        "name": "row_top2", "route": "cuda",
        "source": "hfnet_slam_torch/csrc/row_top2.cu",
        "replaces": "hfnet_slam_tpu/ops/pallas_match.py:52",
        "launches": (n_browse + n_loop + n_reloc + n_track + n_async + n_euroc + n_vi + n_via
                     + sum(depth["launches"].values()) + n_cnn + n_mesh + n_stream + n_corr),
        "launches_by_path": {"browse": n_browse, "loop": n_loop, "relocalization": n_reloc,
                             "relocalization_calls": n_reloc_calls,
                             "extraction_track": n_track, "extraction_matcher_call": n_call,
                             "loop_async": n_async, "euroc_runner": n_euroc, "vi": n_vi,
                             "vi_async": n_via, **depth["launches"], "cnn": n_cnn,
                             "cnn_matcher_call": n_cnn_call, "mesh": n_mesh,
                             "stream": n_stream, "synthetic_corridor": n_corr},
        "launches_by_shape": {"browse": shapes_browse, "loop": shapes_loop,
                              "relocalization": shapes_reloc, "extraction_track": shapes_track,
                              "extraction_matcher_call": shapes_call,
                              "loop_async": shapes_async, "euroc_runner": shapes_euroc,
                              "vi": shapes_vi, "vi_async": shapes_via, **depth["shapes"],
                              "cnn": shapes_cnn, "cnn_matcher_call": shapes_cnn_call,
                              "mesh": shapes_mesh, "stream": shapes_stream,
                              "synthetic_corridor": shapes_corr},
        "loop_async_launches_by_thread": threads_async,
        "vi_async_launches_by_thread": threads_via,
        "stream_launches_by_thread": threads_stream,
        "max_abs_err": max_err,
        **timings[0],
        "bound_peak": "3xTF32 on the tensor cores, 495 TFLOP/s",
        "shapes": timings[1:],
        "recheck_on_path_inputs": [rech_loop, rech_reloc, rech_track, rech_call, rech_async,
                                   rech_euroc, rech_via, *depth["rechecks"], rech_cnn,
                                   rech_stream],
    }
    log(smi)
    log(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
