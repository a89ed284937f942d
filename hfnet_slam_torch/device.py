"""Device selection and float32 precision policy shared by the entry points."""
from __future__ import annotations

import os

import torch

# kernels the port compiles at first use (nvcc, g++) go here; .gitignore
# lists it
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")


def resolve(device=None) -> torch.device:
    """None means CUDA. A CUDA request without a CUDA device raises: the port
    never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hfnet_slam_torch: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def full_fp32() -> None:
    """Full float32 matmuls and convolutions. The reference's tests run at
    'highest' matmul precision; TF32 keeps ~3 decimal digits and flips
    near-tie argmaxes in the matchers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
