"""Host-clock spans around calls into the program's layers.

After chip_smoke.py's StageTimes (commit 27c9911): a wrapper set on an
object's attribute records each call's start and end; with `fence` the
device is synchronized at both ends, so a span holds the device work its
calls launched. While `marking`, each span boundary also launches a
marker kernel (torch.cuda._sleep(0), `spin_kernel`) on the current stream,
so the profiler's device timeline can be cut at the same boundaries: the
kernels between a span's two markers are the ones it launched.
"""
from __future__ import annotations

import time

import torch


class Spans:
    def __init__(self, fence=True):
        self.fence = fence
        self.marking = False
        self.spans = {}        # label -> [(t0, t1, info)]
        self.boundaries = []   # (label, "B" | "E", info) in launch order while marking
        self._saved = []

    def wrap(self, obj, attr, label, info=None):
        """Replace obj.attr by a recording wrapper; `info(args)` adds data to
        each span (e.g. an input shape)."""
        fn = getattr(obj, attr)
        self._saved.append((obj, attr, obj.__dict__.get(attr) if hasattr(obj, "__dict__")
                            else None))

        def run(*args, **kw):
            extra = info(args) if info is not None else None
            self._mark(label, "B", extra)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                if self.fence:
                    torch.cuda.synchronize()
                return out
            finally:
                t1 = time.perf_counter()
                self._mark(label, "E", extra)
                self.spans.setdefault(label, []).append((t0, t1, extra))

        setattr(obj, attr, run)
        return run

    def wrap_call(self, holder, attr, label):
        """Replace the callable object holder.attr by a recording one that
        passes other attribute reads through (a call on an instance looks
        `__call__` up on its class, which setattr on the instance misses)."""
        obj = getattr(holder, attr)
        rec = self

        class Recorded:
            def __getattr__(self, name):
                return getattr(obj, name)

            def __call__(self, *args, **kw):
                with rec.span(label):
                    return obj(*args, **kw)

        self._saved.append((holder, attr, obj))
        setattr(holder, attr, Recorded())

    def _mark(self, label, kind, extra):
        if self.fence and kind == "B":
            torch.cuda.synchronize()
        if self.marking:
            torch.cuda._sleep(0)
            self.boundaries.append((label, kind, extra))

    def span(self, label):
        """Context manager recording one span of the harness's own code."""
        return _Span(self, label)

    def restore(self):
        for obj, attr, old in reversed(self._saved):
            if old is None:
                try:
                    delattr(obj, attr)
                except AttributeError:
                    pass
            else:
                setattr(obj, attr, old)
        self._saved.clear()

    def durations(self, label):
        return [t1 - t0 for t0, t1, _ in self.spans.get(label, [])]


class _Span:
    def __init__(self, rec, label):
        self.rec, self.label = rec, label

    def __enter__(self):
        self.rec._mark(self.label, "B", None)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.rec.fence:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.rec._mark(self.label, "E", None)
        self.rec.spans.setdefault(self.label, []).append((self.t0, t1, None))
        return False
