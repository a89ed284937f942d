"""The device trace of a traced run: torch.profiler over a few slices of
the measured window (one profiler session each, started and stopped
between frames), CUDA activity only, read straight from the Kineto events
(no CPU operator events, which would double the trace).

From it: the device's busy seconds (the union of kernel, copy and set
intervals) in the traced slices, kernel time by name, and, through the
span markers (harness/spans.py), which spans each kernel ran in and what
the host was doing during each idle gap of the device within a slice. A
slice whose markers and span boundaries differ in number is left out of
that placement (the count is logged).
"""
from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"
SETTLE_S = 0.05   # after a session starts, before the slice's first marker


class Trace:
    def __init__(self):
        self.sessions = []   # the profiler, host start and boundary index of each slice
        self.kernels = []    # (name, start_ns, end_ns), markers excluded
        self.markers = []    # start_ns of each marker, in device order
        self.cuts = set()    # start_ns of each later slice's first activity
        self.slices = []     # per slice: host start and seconds, busy ns, markers, boundaries

    def start(self, n_boundaries):
        """Start a slice; `n_boundaries` spans.boundaries hold before it."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        time.sleep(SETTLE_S)
        self.sessions.append({"prof": prof, "h0": time.perf_counter(), "b0": n_boundaries})

    def stop(self, n_boundaries):
        """End the slice; its events are read later by `read`, after the
        measured window."""
        torch.cuda.synchronize()
        self.sessions[-1].update(h1=time.perf_counter(), b1=n_boundaries)
        self.sessions[-1]["prof"].__exit__(None, None, None)

    def read(self):
        t = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        t_first = self.sessions[0]["h0"] if self.sessions else 0.0
        for ses in self.sessions:
            kernels, markers = [], []
            for e in ses["prof"].profiler.kineto_results.events():
                if e.device_type() != cuda:
                    continue
                name = e.name()
                s = e.start_ns()
                if MARKER in name:
                    markers.append(s)
                else:
                    kernels.append((name, s, s + e.duration_ns()))
            kernels.sort(key=lambda k: k[1])
            markers.sort()
            if kernels and self.kernels:
                self.cuts.add(kernels[0][1])
            self.slices.append({"start": ses["h0"] - t_first, "secs": ses["h1"] - ses["h0"],
                                "busy_ns": _union_ns(kernels), "markers": markers,
                                "b": (ses["b0"], ses["b1"])})
            self.kernels.extend(kernels)
            self.markers.extend(markers)
        self.sessions = []
        self.kernels.sort(key=lambda k: k[1])
        self.read_s = time.perf_counter() - t

    @property
    def window_s(self):
        return sum(sl["secs"] for sl in self.slices)

    def slice_idle(self):
        """[start s (from the first slice), seconds, idle %, markers, span
        boundaries] of each slice."""
        return [[sl["start"], sl["secs"], 100.0 * (1.0 - sl["busy_ns"] * 1e-9 / sl["secs"]),
                 len(sl["markers"]), sl["b"][1] - sl["b"][0]] for sl in self.slices]

    def busy_s(self):
        """Seconds in which some device activity ran (union of intervals)."""
        return _union_ns(self.kernels) * 1e-9

    def by_name(self, top=10):
        acc = {}
        for n, s, e in self.kernels:
            acc[n] = acc.get(n, 0) + (e - s)
        return sorted(([n, v * 1e-9] for n, v in acc.items()), key=lambda x: -x[1])[:top]

    def intervals(self, boundaries):
        """Device-time intervals of each span: a list of (label, info, start,
        end) from pairing each slice's markers with its part of the host's
        boundary list, or None when no slice pairs (a slice whose counts
        differ cannot be placed and is left out)."""
        out, self.placed = [], []
        for sl in self.slices:
            bs, ms = boundaries[sl["b"][0]:sl["b"][1]], sl["markers"]
            if len(bs) != len(ms) or not bs:
                continue
            stack, part = [], []
            for (label, kind, info), t in zip(bs, ms):
                if kind == "B":
                    stack.append((label, info, t))
                elif stack:
                    lab, inf, t0 = stack.pop()
                    part.append((lab, inf, t0, t))
            if not stack:
                out.extend(part)
                self.placed.append((ms[0], ms[-1]))
        return out or None

    def kernel_ns_in(self, spans):
        """Kernel nanoseconds inside the given (start, end) device intervals
        (which do not overlap)."""
        spans = sorted(spans)
        tot, j = 0, 0
        for _, s, e in self.kernels:
            while j < len(spans) and spans[j][1] <= s:
                j += 1
            if j < len(spans) and spans[j][0] <= s and e <= spans[j][1]:
                tot += e - s
        return tot

    def idle_gaps(self, boundaries, top=10, min_ns=0):
        """The longest stretches with no device activity inside a traced
        slice whose markers were placed, each named by the innermost span
        open when it began (or `between` when none was)."""
        ivs = self.intervals(boundaries)
        if ivs is None or not self.kernels:
            return None
        gaps, end = [], None
        for _, s, e in self.kernels:
            if end is not None and s > end + min_ns and s not in self.cuts and \
                    any(a <= end < b for a, b in self.placed):
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        ivs.sort(key=lambda x: x[2])

        def label_at(t):
            best = None
            for lab, _, a, b in ivs:
                if a > t:
                    break
                if b > t and (best is None or a >= best[1]):
                    best = (lab, a)
            return best[0] if best else "between"

        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[label_at(a), (b - a) * 1e-9] for a, b in gaps[:top]]


def _union_ns(kernels):
    """Nanoseconds covered by the (name, start, end) intervals, sorted by start."""
    busy, end = 0, None
    for _, s, e in kernels:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy
