"""The per-frame feature record every extractor emits.

Counterpart of the `Features` record in hfnet_slam_tpu/models/extractor.py
(the HF-Net pyramid extractor itself is a later slice).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    """Per-frame extracted features, fixed capacity N = pad_to."""

    xy: torch.Tensor           # (N,2) level-0 pixel coords [x, y], float32
    score: torch.Tensor        # (N,) float32
    octave: torch.Tensor       # (N,) int32 pyramid level
    desc: torch.Tensor         # (N,D) L2-normalized local descriptors
    mask: torch.Tensor         # (N,) bool valid
    global_desc: torch.Tensor  # (G,) float32

    def to(self, device) -> "Features":
        return Features(*(x.to(device) for x in self))
