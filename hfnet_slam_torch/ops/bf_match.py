"""Brute-force mutual descriptor matcher: the hand-written CUDA kernel
(csrc/row_top2.cu), its wrapper, and its plain PyTorch version.

Counterpart of hfnet_slam_tpu/ops/pallas_match.py:row_top2 (the repo's one
Pallas TPU kernel) and its gated wrapper match_descriptors_fused.

Routing: a CUDA tensor goes to the kernel (or the wrapper raises); a CPU
tensor goes to `row_top2_reference`. There is no fallback from one to the
other. The kernel is built with nvcc for sm_90a at first use into the
package's build directory and bound through ctypes with a plain C interface.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from .. import device as D

_NEG = -1e9
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "row_top2.cu")
_LIB_PATH = os.path.join(D.BUILD_DIR, "librow_top2.so")

# kernel launches made by row_top2 on CUDA tensors (one per wrapper call,
# which runs the partial and the merge kernel); reset by callers that count
launches = 0

_lib = None
_lib_lock = threading.Lock()
_nsplits: dict = {}  # (device index, NA, NB) -> column splits of one launch


def nvcc_command(src=_SRC, out=_LIB_PATH):
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", out, src]


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its source.
    Returns the library path; raises CalledProcessError with nvcc's output on
    a compile error."""
    if force or not os.path.exists(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        os.makedirs(D.BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(nvcc_command(out=tmp), check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.row_top2_nsplit.argtypes = [i, i, i]
            lib.row_top2_nsplit.restype = i
            lib.row_top2_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p, p]
            lib.row_top2_launch.restype = i
            _lib = lib
    return _lib


def _nsplit(lib, NA, NB) -> int:
    """Column splits of one launch on the current device, cached per shape."""
    key = (torch.cuda.current_device(), NA, NB)
    if key not in _nsplits:
        n_sm = torch.cuda.get_device_properties(key[0]).multi_processor_count
        _nsplits[key] = lib.row_top2_nsplit(NA, NB, n_sm)
    return _nsplits[key]


def row_top2_reference(dA, dB, maskB):
    """Plain version: (best, second, idx) of each row of dA . dB^T with
    masked columns at -1e9, written as pallas_match._match_kernel does it."""
    s = dA @ dB.T
    s = torch.where(maskB[None, :], s, _NEG)
    best = torch.max(s, 1).values
    idx = torch.argmax(s, 1)  # first maximal index on ties, as jnp.argmax
    s2 = s.scatter(1, idx[:, None], _NEG)
    return best, torch.max(s2, 1).values, idx.to(torch.int32)


def _check(dA, dB, maskB):
    if dA.dim() != 2 or dB.dim() != 2 or dA.shape[1] != dB.shape[1]:
        raise ValueError(f"row_top2: need (NA,D) and (NB,D), got {tuple(dA.shape)} "
                         f"and {tuple(dB.shape)}")
    if maskB.shape != (dB.shape[0],) or maskB.dtype != torch.bool:
        raise ValueError("row_top2: maskB must be a (NB,) bool tensor")
    if dA.dtype != torch.float32 or dB.dtype != torch.float32:
        raise TypeError("row_top2: descriptors must be float32")
    if not (dA.device == dB.device == maskB.device):
        raise ValueError("row_top2: tensors on different devices")
    if dA.shape[0] < 1 or dB.shape[0] < 1 or dA.shape[1] < 1:
        raise ValueError("row_top2: empty input")


def row_top2(dA, dB, maskB):
    """Fused row-wise top-2 similarity: returns (best (NA,) f32, second (NA,)
    f32, idx (NA,) int32). CUDA tensors run the hand-written kernel."""
    global launches
    _check(dA, dB, maskB)
    if dA.device.type == "cpu":
        return row_top2_reference(dA, dB, maskB)
    if dA.device.type != "cuda":
        raise ValueError(f"row_top2: unsupported device {dA.device}")
    if not (dA.is_contiguous() and dB.is_contiguous() and maskB.is_contiguous()):
        raise ValueError("row_top2: inputs must be contiguous")
    lib = _load()
    NA, Dd = dA.shape
    NB = dB.shape[0]
    with torch.cuda.device(dA.device):
        nsplit = _nsplit(lib, NA, NB)
        i32 = dict(dtype=torch.int32, device=dA.device)
        # partial (best, second, idx) per (split, row) in one buffer; the two
        # float planes are reinterpreted int32 storage
        scratch = torch.empty((3, nsplit, NA), **i32)
        sb, ss = scratch[0].view(torch.float32), scratch[1].view(torch.float32)
        best = torch.empty(NA, dtype=torch.float32, device=dA.device)
        second, idx = torch.empty_like(best), torch.empty(NA, **i32)
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        err = lib.row_top2_launch(
            dA.data_ptr(), dB.data_ptr(), maskB.data_ptr(), NA, NB, Dd, nsplit,
            sb.data_ptr(), ss.data_ptr(), scratch[2].data_ptr(),
            best.data_ptr(), second.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_top2 kernel launch failed: cudaError_t {err}")
    launches += 1
    return best, second, idx


def match_descriptors_fused(dA, maskA, dB, maskB, max_dist: float = 0.6,
                            ratio: float = 1.0):
    """Mutual brute-force matching: row_top2 forward and with A and B
    swapped, then the distance, ratio, mutual and maskA gates as elementwise
    ops on the device. Returns (idx (NA,) int32 or -1, dist (NA,))."""
    bestA, secondA, idxB = row_top2(dA, dB, maskB)
    _, _, idxA_of_B = row_top2(dB, dA, maskA)
    ok = bestA > _NEG / 2
    d = torch.sqrt(torch.clamp(2.0 - 2.0 * torch.clamp(bestA, -1.0, 1.0), min=0.0))
    d2nd = torch.sqrt(torch.clamp(2.0 - 2.0 * torch.clamp(secondA, -1.0, 1.0), min=0.0))
    ok &= d < max_dist
    if ratio < 1.0:
        ok &= d < ratio * d2nd
    idxB = idxB.long()
    mutual = idxA_of_B[torch.clamp(idxB, 0, dB.shape[0] - 1)].long() == \
        torch.arange(dA.shape[0], device=dA.device)
    ok &= mutual & maskA
    idx = torch.where(ok, idxB, -1).to(torch.int32)
    return idx, torch.where(idx >= 0, d, 0.0)
