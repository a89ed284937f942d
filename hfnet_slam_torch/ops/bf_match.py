"""Brute-force mutual descriptor matcher: the hand-written CUDA kernel
(csrc/row_top2.cu), its wrapper, and its plain PyTorch version.

Counterpart of hfnet_slam_tpu/ops/pallas_match.py:row_top2 (the repo's one
Pallas TPU kernel) and its gated wrapper match_descriptors_fused.

Routing: a CUDA tensor goes to the kernel (or the wrapper raises); a CPU
tensor goes to `row_top2_reference`. There is no fallback from one to the
other. The kernel is built with nvcc for sm_90a at first use into the
package's build directory and bound through ctypes with a plain C interface;
it finds libcuda's TMA descriptor encoder (cuTensorMapEncodeTiled) through
the CUDA runtime's entry-point query, so the library does not link libcuda.
"""
from __future__ import annotations

import collections
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
_NO_ENCODER = -1000000  # row_top2_launch: cuTensorMapEncodeTiled not found

# kernel launches made by row_top2 on CUDA tensors (one per wrapper call),
# in all, by (NA, NB, D) and by (thread name, NA, NB, D); reset by callers
# that count (`reset_counts`). The async pipeline launches from its worker
# threads, so every update holds _count_lock
launches = 0
shape_launches = collections.Counter()
thread_shape_launches = collections.Counter()
_count_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()
# (device index, stream, NA, NB) -> (column splits, scratch or None); a
# scratch is reused only on its own stream, where calls are ordered
_plans: dict = {}


def nvcc_command(src=_SRC, out=_LIB_PATH):
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-o", out, src]


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its source.
    Returns the library path; raises RuntimeError with nvcc's output on a
    compile error. ptxas's report (registers, shared memory, spills of each
    kernel) is kept beside the library, see `ptxas_report`."""
    if force or not os.path.exists(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        os.makedirs(D.BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        r = subprocess.run(nvcc_command(out=tmp), capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}) on {_SRC}:\n{r.stdout}{r.stderr}")
        with open(_LIB_PATH + ".ptxas.txt", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def ptxas_report() -> list:
    """ptxas's report of the last build: per kernel, the line naming it, its
    stack and spills, and its registers; and any performance remark."""
    with open(_LIB_PATH + ".ptxas.txt") as f:
        return [ln.strip() for ln in f
                if any(k in ln for k in ("Compiling entry", "spill", "Used", "Performance"))]


def bind(path):
    """The kernel library at `path` with its C interface declared."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.row_top2_nsplit.argtypes = [i, i, i]
    lib.row_top2_nsplit.restype = i
    lib.row_top2_scratch_words.argtypes = [i, i]
    lib.row_top2_scratch_words.restype = ctypes.c_longlong
    lib.row_top2_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, i, p]
    lib.row_top2_launch.restype = i
    lib.row_top2_error_string.argtypes = [i]
    lib.row_top2_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def _plan(lib, dev, stream, NA, NB):
    """Column splits of one launch and the scratch for their partial
    (best, second, idx) states and merge tickets, cached per device, stream
    and shape. The kernel leaves the tickets at zero, as it finds them."""
    key = (dev.index, stream, NA, NB)
    capturing = torch.cuda.is_current_stream_capturing()
    with _lib_lock:  # threads on one stream share its plan
        plan = _plans.get(key)
        if plan is None or (capturing and plan[1] is not None):
            nsplit = plan[0] if plan else lib.row_top2_nsplit(
                NA, NB, torch.cuda.get_device_properties(dev).multi_processor_count)
            words = lib.row_top2_scratch_words(NA, nsplit)
            scratch = torch.zeros(words, dtype=torch.int32, device=dev) if words else None
            plan = (nsplit, scratch)
            if not capturing:  # a graph owns the scratch it captured: replays may
                _plans[key] = plan  # run on any stream
    return plan


def count_launch(shape):
    """Add one launch at `shape` = (NA, NB, D) from the calling thread."""
    global launches
    with _count_lock:
        launches += 1
        shape_launches[shape] += 1
        thread_shape_launches[(threading.current_thread().name,) + shape] += 1


def reset_counts():
    """Zero every launch count."""
    global launches
    with _count_lock:
        launches = 0
        shape_launches.clear()
        thread_shape_launches.clear()


def _tma_ready(x, ld):
    """x itself when TMA can read it (16-byte-aligned base, rows of ld
    floats), else a copy into an aligned (N, ld) buffer, zero-padded."""
    if x.shape[1] == ld and x.data_ptr() % 16 == 0:
        return x
    y = torch.zeros((x.shape[0], ld), dtype=x.dtype, device=x.device)
    y[:, :x.shape[1]] = x
    return y


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
    _check(dA, dB, maskB)
    if dA.device.type == "cpu":
        return row_top2_reference(dA, dB, maskB)
    if dA.device.type != "cuda":
        raise ValueError(f"row_top2: unsupported device {dA.device}")
    if not (dA.is_contiguous() and dB.is_contiguous() and maskB.is_contiguous()):
        raise ValueError("row_top2: inputs must be contiguous")
    return _launch(_lib or _load(), dA, dB, maskB,
                   torch.cuda.current_stream(dA.device).cuda_stream)


def _launch(lib, dA, dB, maskB, stream):
    """One launch of the kernel library `lib` on `stream`, counted."""
    (NA, Dd), NB = dA.shape, dB.shape[0]
    ld = (Dd + 3) // 4 * 4  # TMA: rows a multiple of 16 bytes
    dA, dB = _tma_ready(dA, ld), _tma_ready(dB, ld)
    dev = dA.device
    nsplit, scratch = _plan(lib, dev, stream, NA, NB)
    best = torch.empty(NA, dtype=torch.float32, device=dev)
    second = torch.empty(NA, dtype=torch.float32, device=dev)
    idx = torch.empty(NA, dtype=torch.int32, device=dev)
    err = lib.row_top2_launch(
        dA.data_ptr(), dB.data_ptr(), maskB.data_ptr(), NA, NB, ld, nsplit,
        None if scratch is None else scratch.data_ptr(),
        best.data_ptr(), second.data_ptr(), idx.data_ptr(), dev.index, stream)
    if err > 0:
        raise RuntimeError(f"row_top2 kernel launch failed: cudaError_t {err} "
                           f"({lib.row_top2_error_string(err).decode()})")
    if err == _NO_ENCODER:
        raise RuntimeError("row_top2: libcuda offers no cuTensorMapEncodeTiled (CUDA >= 12)")
    if err < 0:
        raise RuntimeError(f"row_top2: cuTensorMapEncodeTiled failed: CUresult {-err}")
    count_launch((NA, NB, Dd))
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
