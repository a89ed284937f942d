"""Where the first optimize_sim3 call of a process spends its time, on the card.

    python3 -m hfnet_slam_torch.tools.sim3_cold_start

The loop circuit's first OptimizeSim3 takes seconds, later ones well under
one. This splits that cold start. Each case runs in a fresh process (a new
CUDA context, nothing loaded) at the loop closer's shape: 512 padded pairs
(LoopCloserConfig.pair_cap), 240 of them valid, the scenes' pinhole camera.

  cold         optimize_sim3 four times, nothing called before it but the
               context creation and the input upload;
  libs_first   first the linear-algebra calls of the loop path, each timed on
               its first and second call (solve_ex 7x7, the batched and the
               single 3x3 SVD, det), then optimize_sim3 four times;
  host_first   first one optimize_sim3 iteration on CPU copies of the inputs
               (torch.func's first use on the host, no CUDA kernel), then
               optimize_sim3 four times on the card.

Inside every optimize_sim3 call the script times, behind
torch.cuda.synchronize fences, each `torch.func.jacfwd` evaluation (the
float64 forward-mode Jacobian) and each `torch.linalg.solve_ex`; the rest of
the call is the eager float32 residual, cost and update ops. The first
call's first jacfwd, set against later ones, is the autodiff cold start;
`cold` minus `host_first` in it is torch.func's host-side first use, the
remainder the first launches of its CUDA kernels. `cold` minus `libs_first`
in the first call's solve_ex is the cost of loading the solver library on
first use. Prints one JSON object; needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_PAIRS, N_VALID, N_CALLS = 512, 240, 4


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _inputs(dev):
    """A Sim3-related pair set: frame-1 points, the same points in frame 2,
    their pixels with 0.5 px noise, and a perturbed initial Sim3."""
    from .. import lie
    from ..geometry import cameras

    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device=dev)
    rng = np.random.default_rng(0)
    p1 = np.c_[rng.uniform(-2, 2, (N_PAIRS, 2)), rng.uniform(3, 8, N_PAIRS)].astype(np.float32)
    xi = torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.01, 0.1])
    R, t, s = lie.sim3_exp(xi)
    # p1 = s R p2 + t  =>  p2 = R^T (p1 - t) / s
    p2 = ((torch.from_numpy(p1) - t) @ R) / s
    T = dict(device=dev)
    p1_c, p2_c = torch.from_numpy(p1).to(**T), p2.to(**T)
    uv1 = cam.project(p1_c) + 0.5 * torch.from_numpy(rng.standard_normal((N_PAIRS, 2))
                                                     .astype(np.float32)).to(**T)
    uv2 = cam.project(p2_c) + 0.5 * torch.from_numpy(rng.standard_normal((N_PAIRS, 2))
                                                     .astype(np.float32)).to(**T)
    isig = torch.ones(N_PAIRS, **T)
    valid = torch.zeros(N_PAIRS, dtype=torch.bool, **T)
    valid[:N_VALID] = True
    R0, t0, s0 = lie.sim3_exp(xi + 0.01)
    return cam, (R0.to(**T), t0.to(**T), s0.to(**T), p1_c, p2_c, uv1, uv2, isig, isig, valid)


def _linalg_first(dev):
    """First and second call of each linear-algebra routine the loop path
    reaches, ms."""
    g = torch.Generator().manual_seed(1)
    H = torch.randn(7, 7, generator=g)
    H = (H @ H.T + torch.eye(7)).to(dev)
    b = torch.randn(7, generator=g).to(dev)
    M3b = torch.randn(64, 3, 3, generator=g).to(dev)
    M3 = torch.randn(3, 3, generator=g).to(dev)
    calls = {"solve_ex_7x7_f32": lambda: torch.linalg.solve_ex(H, b),
             "svd_3x3_batch64_f32": lambda: torch.linalg.svd(M3b),
             "svd_3x3_single_f32": lambda: torch.linalg.svd(M3),
             "det_3x3_batch64_f32": lambda: torch.linalg.det(M3b)}
    return {k: [_sync_ms(f)[1] for _ in range(2)] for k, f in calls.items()}


def child(case, dev="cuda"):
    from ..optim import sim3

    dev = torch.device(dev)
    out = {"case": case}
    _, out["context_ms"] = _sync_ms(lambda: torch.zeros(1, device=dev))
    (cam, args), out["inputs_ms"] = _sync_ms(lambda: _inputs(dev))
    if case == "libs_first":
        out["linalg_first_second_ms"] = _linalg_first(dev)
    if case == "host_first":
        cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
        _, out["host_iteration_ms"] = _sync_ms(
            lambda: sim3.optimize_sim3(cam.kind, cam.params.cpu(), *cpu, n_iters=1))

    parts = {"jacfwd": [], "solve_ex": []}
    real_jacfwd, real_solve_ex = torch.func.jacfwd, torch.linalg.solve_ex

    def timed(name, fn):
        def run(*a, **kw):
            res, ms = _sync_ms(lambda: fn(*a, **kw))
            parts[name].append(ms)
            return res
        return run

    torch.func.jacfwd = lambda f, *a, **kw: timed("jacfwd", real_jacfwd(f, *a, **kw))
    torch.linalg.solve_ex = timed("solve_ex", real_solve_ex)
    calls = []
    try:
        for _ in range(N_CALLS):
            for v in parts.values():
                v.clear()
            res, ms = _sync_ms(lambda: sim3.optimize_sim3(cam.kind, cam.params, *args))
            jac, sol = list(parts["jacfwd"]), list(parts["solve_ex"])
            calls.append({"ms": ms, "jacfwd_ms": sum(jac), "jacfwd_first_iter_ms": jac[0],
                          "jacfwd_later_iter_ms_mean": float(np.mean(jac[1:])),
                          "solve_ex_ms": sum(sol), "solve_ex_first_iter_ms": sol[0],
                          "rest_ms": ms - sum(jac) - sum(sol), "iters": len(jac),
                          "n_inliers": int(res["n_inliers"])})
    finally:
        torch.func.jacfwd, torch.linalg.solve_ex = real_jacfwd, real_solve_ex
    out["optimize_sim3_calls"] = calls
    print(json.dumps(out), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("sim3_cold_start: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "CUDA_MODULE_LOADING": os.environ.get("CUDA_MODULE_LOADING")}
    for case in ("cold", "libs_first", "host_first"):
        p = subprocess.run([sys.executable, "-m", __spec__.name, "--child", case],
                           capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            sys.stderr.write(p.stderr)
            sys.exit(f"sim3_cold_start: case {case} failed")
        res[case] = json.loads(p.stdout.strip().splitlines()[-1])
    print(json.dumps(res))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        main()
