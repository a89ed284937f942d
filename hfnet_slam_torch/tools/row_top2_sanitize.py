"""Run the row_top2 kernel under compute-sanitizer (GPU).

    python3 -m hfnet_slam_torch.tools.row_top2_sanitize [--timeout 300]

For each of the memcheck, racecheck and synccheck tools it starts
`compute-sanitizer --tool <tool>` on a child process of this module, which
launches the kernel at the card tests' shapes (tests/test_torch_cuda.py):
odd D, a base 4 bytes past 16-byte alignment, NB = 1, an all-masked B, exact
ties, and the split-merge shapes, each held against row_top2_reference. It
prints one line per tool: whether the tool ran, its exit code, its error
summary, and whether the child's comparisons held. compute-sanitizer is
looked up beside nvcc; when it is not there, or cannot attach on this
machine, the line says so.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPES = [(1024, 1024, 256), (1000, 777, 256), (130, 4097, 64), (1024, 2048, 256),
          (2048, 1024, 256), (1024, 4096, 256), (4096, 1024, 256), (1024, 8192, 256),
          (37, 1, 16), (100, 300, 13)]
TOOLS = ("memcheck", "racecheck", "synccheck")


def _child() -> int:
    import torch

    from hfnet_slam_torch import device as D
    from hfnet_slam_torch.ops import bf_match as B

    D.full_fp32()
    g = torch.Generator(device="cuda").manual_seed(0)

    def unit(n, d):
        return torch.nn.functional.normalize(
            torch.randn(n, d, device="cuda", generator=g), dim=1)

    def problem(NA, NB, Dd):
        A, Bm = unit(NA, Dd), unit(NB, Dd)
        n = min(NA, NB) // 4
        Bm[:n] = torch.nn.functional.normalize(
            A[:n] + 0.03 * torch.randn(n, Dd, device="cuda", generator=g), dim=1)
        return A, Bm, torch.rand(NB, device="cuda", generator=g) > 0.1

    def misaligned(x):
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
        off = (1 - buf.data_ptr() // 4) % 4
        y = buf[off:off + x.numel()].view(x.shape)
        y.copy_(x)
        return y

    cases = [(f"{s}", *problem(*s)) for s in SHAPES]
    A, Bm, m = problem(1000, 777, 256)
    cases.append(("misaligned base", misaligned(A), misaligned(Bm), m))
    A, Bm = unit(512, 256), unit(700, 256)
    Bm[300] = Bm[5]
    A[:3] = Bm[5]
    ones = torch.ones(700, dtype=torch.bool, device="cuda")
    cases += [("exact ties", A, Bm, ones), ("all masked", A, Bm, ~ones),
              ("NB = 1", A, Bm[:1].contiguous(), ones[:1].contiguous())]
    bad = 0
    for label, A, Bm, m in cases:
        _, _, idx = B.row_top2(A, Bm, m)
        _, _, ri = B.row_top2_reference(A, Bm, m)
        torch.cuda.synchronize()
        n = int((idx != ri).sum())
        bad += n
        print(f"  {label}: {n} idx differ", flush=True)
    print(f"CHILD_DONE bad={bad}", flush=True)
    return 1 if bad else 0


def _sanitizer() -> str:
    import shutil

    from hfnet_slam_torch.ops import bf_match as B

    cand = os.path.join(os.path.dirname(B.nvcc_command()[0]), "compute-sanitizer")
    return cand if os.path.exists(cand) else (shutil.which("compute-sanitizer") or "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds allowed to each tool's run")
    args = ap.parse_args(argv)
    if args.child:
        return _child()
    exe = _sanitizer()
    if not exe:
        print("row_top2_sanitize: compute-sanitizer not found beside nvcc or on PATH")
        return 0
    print(f"row_top2_sanitize: {exe}")
    for tool in TOOLS:
        cmd = [exe, "--tool", tool, "--error-exitcode", "97", sys.executable, "-m",
               "hfnet_slam_torch.tools.row_top2_sanitize", "--child"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(f"{tool}: timed out after {args.timeout:.0f} s")
            continue
        lines = (r.stdout + r.stderr).splitlines()
        summary = [ln for ln in lines if "ERROR SUMMARY" in ln or "RACECHECK SUMMARY" in ln]
        done = [ln for ln in lines if ln.startswith("CHILD_DONE")]
        print(f"{tool}: exit {r.returncode}; {'; '.join(summary) or 'no summary line'}; "
              f"{done[0] if done else 'child did not finish'}")
        if r.returncode != 0 or not done:
            # the tool's own reports first (what it flagged, and where),
            # then the end of the child's output
            tool_lines = [ln for ln in lines if ln.startswith("=========")
                          and "Host Frame" not in ln and "backtrace" not in ln]
            for ln in tool_lines[:40] + ["..."] + lines[-8:]:
                print(f"  | {ln}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
