"""Per-stage timing registry (the reference's REGISTER_TIMES).

Counterpart of hfnet_slam_tpu/utils/timing.py: `with timings.section("name"):`
around any stage records its host seconds; `block(x)` inside a section waits
for the card (torch.cuda.synchronize when x holds a CUDA tensor) so the
sample covers the device work, and passes x through. `report()` prints
n / mean / std / p50 / p95 ms per stage (System::PrintTimeStats).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import numpy as np
import torch


def _has_cuda_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_has_cuda_tensor(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_has_cuda_tensor(v) for v in x)
    return False


class TimingRegistry:
    def __init__(self):
        self._samples = defaultdict(list)
        self._lock = threading.Lock()  # sections may close on worker threads

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def block(self, x):
        """Wait for the card when x holds a CUDA tensor (a tensor, or a
        dict/list/tuple of them, e.g. a Features record); returns x."""
        if _has_cuda_tensor(x):
            torch.cuda.synchronize()
        return x

    def add(self, name: str, seconds: float):
        with self._lock:
            self._samples[name].append(seconds)

    def stats(self):
        """{name: (n, mean_ms, std_ms, p50_ms, p95_ms)}"""
        with self._lock:
            samples = {k: list(v) for k, v in self._samples.items()}
        out = {}
        for k, v in samples.items():
            a = np.asarray(v) * 1e3
            out[k] = (len(a), float(a.mean()), float(a.std()), float(np.median(a)),
                      float(np.percentile(a, 95)))
        return out

    def report(self) -> str:
        """Formatted table (PrintTimeStats)."""
        st = self.stats()
        lines = [f"{'stage':<28}{'n':>6}{'mean ms':>10}{'std':>8}{'p50':>8}{'p95':>8}"]
        for k in sorted(st):
            n, mean, std, p50, p95 = st[k]
            lines.append(f"{k:<28}{n:>6}{mean:>10.2f}{std:>8.2f}{p50:>8.2f}{p95:>8.2f}")
        return "\n".join(lines)

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.report() + "\n")

    def reset(self):
        with self._lock:
            self._samples.clear()


# the process-wide default registry (the reference's static vectors)
timings = TimingRegistry()
