"""The port's recorder: host spans and counters on the frame path (the
reference's REGISTER_TIMES, with a span tree).

Counterpart of hfnet_slam_tpu/utils/timing.py. One process-wide `timings`
object, off by default:

    timings.enable()
    with timings.frame():                 # the root; gives out the frame id
        with timings.span("track"):
            timings.count("h2d_bytes", n) # charged to the innermost span
    print(timings.report())
    timings.disable()

While off, `span()` and `frame()` return one shared no-op context manager
and `count()` returns at once: a flag test each, no clock read, no
allocation, no fence. While on, a span records its name, its start and end
(`time.perf_counter_ns()`), the index of its parent (the innermost span
open on the same thread), the frame id and the thread; spans stay in
memory until `reset()`. No span waits for the card: a span holds the
host's time, and the device's share of it shows in the spans that wait
(the readbacks).

Frame ids: `frame()` opens the root span `frame` unless one is open on the
thread already, and every span below it carries its id. Work for a frame
done on another thread (the async mapping worker) carries the id through
`frame_scope(frame_id())`, taken where the work is handed over.

Counters: `count(name, n)`. The port counts `h2d_bytes` (device.upload),
`mirror_rows` (DeviceMap.sync; -1 for a whole-table upload), `fallbacks`
(frames the fused tracking step handed to the staged path) and `syncs`:
while on, torch's sync debug mode is "warn" on a CUDA build, and each
blocking device-to-host synchronization whose first Python caller outside
torch lies in this package counts one (a caller elsewhere, such as a
benchmark's own fences, counts none). `disable()` restores the previous
mode and warnings hook.

Shared clock: `enable()` reads `time.perf_counter_ns()` and `time.time_ns()`
back to back (`anchor`); `to_unix_ns(t)` maps a span time onto the
unix-epoch clock of torch.profiler's (Kineto's) events, so an idle gap on
the device timeline can be put down to the span the host was in.

`section()` is `span()`; `add()` records a sample by hand (always, on or
off); `stats()`, `self_stats()`, `report()` (n, mean, std, p50, p95 and mean
self ms per name, System::PrintTimeStats), `save()` and `reset()` read and
clear both.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

SYNC_TEXT = "synchronizing CUDA operation"   # torch's sync debug warning
_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_THIS = os.path.abspath(__file__)


class _Null:
    """The shared no-op span of the off path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _Null()


class SpanRecord:
    """One span: t0/t1 in perf_counter ns (t1 None while open), parent index
    (-1 for none), frame id (-1 outside a frame), thread ident, counters."""

    __slots__ = ("name", "t0", "t1", "parent", "frame", "thread", "counts", "idx")

    def __init__(self, name, parent, frame, thread, idx):
        self.name, self.parent, self.frame, self.thread, self.idx = \
            name, parent, frame, thread, idx
        self.t0 = self.t1 = None
        self.counts = None


class _Span:
    __slots__ = ("reg", "name", "root", "rec", "saved_fid")

    def __init__(self, reg, name, root=False):
        self.reg, self.name, self.root = reg, name, root

    def __enter__(self):
        reg = self.reg
        tls = reg._tls
        stack = reg._stack()
        if self.root:
            self.saved_fid = tls.fid
            tls.fid = next(reg._frame_ids)
            tls.roots += 1
        parent = stack[-1].idx if stack else -1
        with reg._lock:
            rec = SpanRecord(self.name, parent, tls.fid, threading.get_ident(), len(reg._recs))
            reg._recs.append(rec)
        stack.append(rec)
        self.rec = rec
        rec.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec.t1 = t1
        reg = self.reg
        stack = reg._tls.stack
        if stack and stack[-1] is rec:
            stack.pop()
        if self.root:
            reg._tls.fid = self.saved_fid
            reg._tls.roots -= 1
        return False


class _FrameScope:
    __slots__ = ("reg", "fid", "saved")

    def __init__(self, reg, fid):
        self.reg, self.fid = reg, fid

    def __enter__(self):
        self.reg._stack()
        tls = self.reg._tls
        self.saved = tls.fid
        tls.fid = self.fid

    def __exit__(self, *exc):
        self.reg._tls.fid = self.saved
        return False


def _anchor():
    """(perf_counter_ns, time_ns) read back to back: the tightest of five."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


class TimingRegistry:
    def __init__(self):
        self.on = False
        self.anchor = None               # (perf_counter_ns, time_ns) of the last enable()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._recs: list[SpanRecord] = []
        self._frame_ids = itertools.count()
        self._samples = defaultdict(list)   # add()
        self._sync_saved = None

    # -- switching -------------------------------------------------------------
    def enable(self):
        """Switch the recorder on: take the clock anchor and install the
        sync counter."""
        with self._lock:
            if self.on:
                return
            self.anchor = _anchor()
            self._install_sync_hook()
            self.on = True

    def disable(self):
        """Switch it off; what it recorded stays until reset()."""
        with self._lock:
            if not self.on:
                return
            self.on = False
            self._remove_sync_hook()

    # -- recording -------------------------------------------------------------
    def _stack(self):
        tls = self._tls
        try:
            return tls.stack
        except AttributeError:
            tls.stack, tls.fid, tls.roots = [], -1, 0
            return tls.stack

    def span(self, name: str):
        """Context manager recording one span (the shared no-op while off)."""
        if not self.on:
            return NULL_SPAN
        return _Span(self, name)

    section = span

    def frame(self):
        """The root span `frame`, unless one is open on this thread already
        (the entry points nest: track_rgbd calls track_features)."""
        if not self.on:
            return NULL_SPAN
        self._stack()
        if self._tls.roots:
            return NULL_SPAN
        return _Span(self, "frame", root=True)

    def frame_id(self) -> int:
        """The frame id of this thread's open spans; -1 outside a frame or off."""
        if not self.on:
            return -1
        return getattr(self._tls, "fid", -1)

    def frame_scope(self, fid: int):
        """Spans opened inside carry frame id `fid` (work handed to another
        thread for that frame)."""
        if not self.on or fid < 0:
            return NULL_SPAN
        return _FrameScope(self, fid)

    def count(self, name: str, n=1):
        """Add n to counter `name` of the innermost open span on this thread
        (none open: nothing)."""
        if not self.on:
            return
        stack = getattr(self._tls, "stack", None)
        if stack:
            rec = stack[-1]
            if rec.counts is None:
                rec.counts = {}
            rec.counts[name] = rec.counts.get(name, 0) + n

    def add(self, name: str, seconds: float):
        """A sample recorded by hand (on or off)."""
        with self._lock:
            self._samples[name].append(seconds)

    # -- the clock ---------------------------------------------------------------
    def to_unix_ns(self, t_ns):
        """A perf_counter_ns time (or array) on the unix-epoch clock."""
        p, u = self.anchor
        return t_ns - p + u

    # -- sync counter ------------------------------------------------------------
    def _install_sync_hook(self):
        self._sync_saved = None
        if torch.cuda.is_available():
            self._sync_saved = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._prev_show = warnings.showwarning
        warnings.showwarning = self._on_warning
        warnings.filterwarnings("always", message=".*" + SYNC_TEXT, category=UserWarning)
        self._filter = warnings.filters[0]

    def _remove_sync_hook(self):
        if self._sync_saved is not None:
            torch.cuda.set_sync_debug_mode(self._sync_saved)
            self._sync_saved = None
        if warnings.showwarning == self._on_warning:
            warnings.showwarning = self._prev_show
        if self._filter in warnings.filters:
            warnings.filters.remove(self._filter)
            getattr(warnings, "_filters_mutated", lambda: None)()

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and SYNC_TEXT in str(message):
            if self.on and _issued_by_port(sys._getframe(1)):
                self.count("syncs")
            return
        prev = self._prev_show
        if prev is getattr(warnings, "_showwarning_orig", None):
            # respect a catch_warnings(record=True) around us
            warnings._showwarnmsg_impl(warnings.WarningMessage(message, category, filename,
                                                               lineno, file, line))
        else:
            prev(message, category, filename, lineno, file, line)

    # -- reading -----------------------------------------------------------------
    def records(self):
        """The recorded spans in opening order (SpanRecord; t1 None while
        open). A span's parent is an index into this list."""
        with self._lock:
            return list(self._recs)

    def _per_name(self, self_time=False):
        """{name: [ns]} of the closed spans' durations, or self times (less
        their children's durations), with add()'s samples."""
        recs = [r for r in self.records() if r.t1 is not None]
        kids = defaultdict(int)
        if self_time:
            for r in recs:
                if r.parent >= 0:
                    kids[r.parent] += r.t1 - r.t0
        by = defaultdict(list)
        for r in recs:
            by[r.name].append(r.t1 - r.t0 - kids[r.idx])
        with self._lock:
            for k, v in self._samples.items():
                by[k].extend(int(s * 1e9) for s in v)
        return by

    def stats(self):
        """{name: (n, mean_ms, std_ms, p50_ms, p95_ms)}"""
        by = self._per_name()
        out = {}
        for k, v in by.items():
            a = np.asarray(v, np.float64) * 1e-6
            out[k] = (len(a), float(a.mean()), float(a.std()), float(np.median(a)),
                      float(np.percentile(a, 95)))
        return out

    def self_stats(self):
        """{name: mean self ms}: each span's duration less its children's."""
        return {k: float(np.mean(v)) * 1e-6 for k, v in self._per_name(True).items()}

    def report(self) -> str:
        """Formatted table (PrintTimeStats), with each name's mean self ms,
        then each counter's total and its mean a frame."""
        st, self_ms = self.stats(), self.self_stats()
        lines = [f"{'stage':<28}{'n':>6}{'mean ms':>10}{'std':>8}{'p50':>8}{'p95':>8}"
                 f"{'self':>8}"]
        for k in sorted(st):
            n, mean, std, p50, p95 = st[k]
            lines.append(f"{k:<28}{n:>6}{mean:>10.2f}{std:>8.2f}{p50:>8.2f}{p95:>8.2f}"
                         f"{self_ms[k]:>8.2f}")
        totals = defaultdict(int)
        for r in self.records():
            for k, v in (r.counts or {}).items():
                totals[k] += v
        if totals:
            frames = max(st.get("frame", (1,))[0], 1)
            lines.append(f"{'counter':<28}{'total':>14}{'a frame':>12}")
            lines += [f"{k:<28}{v:>14}{v / frames:>12.1f}" for k, v in sorted(totals.items())]
        return "\n".join(lines)

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.report() + "\n")

    def reset(self):
        """Forget every span and sample (call it with no span open)."""
        with self._lock:
            self._recs = []
            self._samples.clear()


def _issued_by_port(f) -> bool:
    """Whether the first Python frame outside torch, the warnings module and
    this file lies in this package."""
    while f is not None:
        fn = f.f_code.co_filename
        if fn == _THIS or fn.startswith(_TORCH_DIR) or fn == warnings.__file__:
            f = f.f_back
            continue
        return fn.startswith(_PORT_DIR)
    return False


# the process-wide default registry (the reference's static vectors)
timings = TimingRegistry()
