"""Where the row_top2 kernel's time goes, on the card.

    python3 -m hfnet_slam_torch.tools.row_top2_breakdown

Times the kernel (csrc/row_top2.cu) beside variants of its own source, each
with one part of the work knocked out by a textual edit and built with the
same nvcc command into build/breakdown/. The variants compute wrong results;
they exist to be timed:
  kernel         the source as it is;
  one_tf32_pass  one wgmma (hi.hi) per k-step instead of three;
  no_split       the splitter warps skip the hi/lo split of B;
  a_first_tile   A's chunks are loaded for a block's first column tile only,
                 so later tiles move half the bytes from L2;
  stages3        a ring of 3 stages instead of 4.
Shapes: the four chip_smoke.py times, and (128,128,32) and (1024,128,256),
which show the fixed cost of a call and the cost of a D chunk in a nearly
idle card. Times are CUDA-event means over a CUDA-graph replay of 100
calls; the variants take turns over three rounds and the median is kept.
The SM clock and board power are sampled with nvidia-smi while the timing
runs. Last, the wrapper's host cost: wall-clock us per eager call of
bf_match.row_top2 at (1024,1024,256) and of each of its steps, over 2000
calls each. Prints one JSON object; needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import device as D
from ..ops import bf_match as B

SHAPES = [(1024, 1024, 256), (1024, 4096, 256), (4096, 1024, 256), (1024, 8192, 256),
          (128, 128, 32), (1024, 128, 256)]
WGMMAS = """\
        wgmma_m64n128k8_tf32(d, alo[kk], desc_sw128(bhi + 32 * kk), (kc | kk) != 0);
        wgmma_m64n128k8_tf32(d, ahi[kk], desc_sw128(blo + 32 * kk), 1);
        wgmma_m64n128k8_tf32(d, ahi[kk], desc_sw128(bhi + 32 * kk), 1);
"""
A_LOAD = """\
        mbar_expect_tx(full(s), A_BYTES + B_BYTES);
        const int t = it / nk, kc = it - t * nk;
        const uint32_t st = sbase + s * STAGE_BYTES;
        tma_load_2d(st, &tmA, full(s), kc * BK, row0);
"""
VARIANTS = {
    "kernel": [],
    "one_tf32_pass": [(WGMMAS, "        wgmma_m64n128k8_tf32(d, ahi[kk], "
                               "desc_sw128(bhi + 32 * kk), (kc | kk) != 0);\n")],
    "no_split": [("for (int e = t; e < B_BYTES / 16; e += N_SPLIT_THREADS) {",
                  "for (int e = t; e < 0; e += N_SPLIT_THREADS) {")],
    "a_first_tile": [(A_LOAD, """\
        const int t = it / nk, kc = it - t * nk;
        mbar_expect_tx(full(s), (t == 0 ? A_BYTES : 0) + B_BYTES);
        const uint32_t st = sbase + s * STAGE_BYTES;
        if (t == 0) tma_load_2d(st, &tmA, full(s), kc * BK, row0);
""")],
    "stages3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
}


def _build(name):
    with open(B._SRC) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"row_top2_breakdown: variant {name}: the source changed, "
                             f"edit no longer applies:\n{old}")
        src = src.replace(old, new)
    out_dir = os.path.join(D.BUILD_DIR, "breakdown")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run(B.nvcc_command(src=cu, out=so), capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"row_top2_breakdown: nvcc failed on {name}:\n{r.stderr}")
    return name, so


def _graph_ms(fn, iters=100, warm=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _host_us(fn, n=2000):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _host_steps(A, Bm, m):
    """us per call of the wrapper and of each step it takes (the kernel's
    own library, a warm plan)."""
    NA, NB, Dd = A.shape[0], Bm.shape[0], A.shape[1]
    lib, dev = B._load(), A.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    nsplit, scratch = B._plan(lib, dev, stream, NA, NB)
    best = torch.empty(NA, dtype=torch.float32, device=dev)
    second = torch.empty(NA, dtype=torch.float32, device=dev)
    idx = torch.empty(NA, dtype=torch.int32, device=dev)
    args = (A.data_ptr(), Bm.data_ptr(), m.data_ptr(), NA, NB, Dd, nsplit,
            scratch.data_ptr() if scratch is not None else None, best.data_ptr(),
            second.data_ptr(), idx.data_ptr(), dev.index, stream)
    return {
        "row_top2": _host_us(lambda: B.row_top2(A, Bm, m)),
        "check": _host_us(lambda: B._check(A, Bm, m)),
        "tma_ready_x2": _host_us(lambda: (B._tma_ready(A, Dd), B._tma_ready(Bm, Dd))),
        "current_stream": _host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "plan": _host_us(lambda: B._plan(lib, dev, stream, NA, NB)),
        "outputs": _host_us(lambda: (torch.empty(NA, dtype=torch.float32, device=dev),
                                     torch.empty(NA, dtype=torch.float32, device=dev),
                                     torch.empty(NA, dtype=torch.int32, device=dev))),
        "launch_call": _host_us(lambda: lib.row_top2_launch(*args)),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("row_top2_breakdown: needs a CUDA card")
    D.full_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = {name: B.bind(so) for name, so in ex.map(_build, VARIANTS)}

    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for NA, NB, Dd in SHAPES:
        A = torch.nn.functional.normalize(torch.randn(NA, Dd, device="cuda", generator=g), dim=1)
        Bm = torch.nn.functional.normalize(torch.randn(NB, Dd, device="cuda", generator=g), dim=1)
        data[(NA, NB, Dd)] = (A, Bm, torch.rand(NB, device="cuda", generator=g) > 0.1)

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    times = {}
    try:
        for rnd in range(3):
            for name in (list(VARIANTS) if rnd % 2 == 0 else list(VARIANTS)[::-1]):
                B._lib, B._plans = libs[name], {}
                for shape, (A, Bm, m) in data.items():
                    times.setdefault(name, {}).setdefault(str(list(shape)), []).append(
                        _graph_ms(lambda: B.row_top2(A, Bm, m)))
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
        B._lib, B._plans = None, {}
    host = _host_steps(*data[(1024, 1024, 256)])
    clocks, power = [], []
    for line in samples:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and all(p.replace(".", "").isdigit() for p in parts):
            clocks.append(float(parts[0]))
            power.append(float(parts[1]))
    print(json.dumps({
        "card": card,
        "ms_median_of_3": {n: {s: statistics.median(v) for s, v in t.items()}
                           for n, t in times.items()},
        "sm_clock_mhz": {"min": min(clocks), "median": statistics.median(clocks),
                         "max": max(clocks)} if clocks else None,
        "power_w": {"median": statistics.median(power), "max": max(power)} if power else None,
        "host_us_per_call_1024x1024x256": host,
    }))


if __name__ == "__main__":
    main()
