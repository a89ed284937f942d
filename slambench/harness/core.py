"""One run of one cell: load, warm up, measure for --seconds, check, report.

Everything that belongs to a cell is found by name under slambench/:
workloads/<cell>.json names the configuration (configs/<name>.json), the
traffic mix (traffic/<name>.json, which names its generator,
generators/<name>.py) and the check's sample sizes and limits, each kind of
sample a module checks/<kind>.py (harness/check.py); each metric of
BENCHMARK.json is read by metrics/<metric>.py. Adding a cell, a mix, a check
or a metric adds files and entries and edits none.

The window is a closed loop with one camera: a frame goes in when the
previous frame's pose has come back, and a frame's latency is the host
clock from the call into the program to the synchronize after it. The
cell's episode is replayed back to back until --seconds are up; starting
an episode counts in the window. Every end-to-end metric is over the
frames that finished inside the window.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # slambench/
ROOT = os.path.dirname(HERE)                                           # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "hfnet_slam_tpu")


class RunError(Exception):
    """A run that cannot produce a result (no card, a missing file, a
    forbidden import); the message goes to standard error."""


def load_json(*parts):
    path = os.path.join(HERE, *parts)
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """slambench/<kind>/<name>.py as a module of the slambench package."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"slambench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell, section):
    """The BENCHMARK.json entries of `section` that the cell reports."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError("missing BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age():
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def setup_env():
    """Build and kernel caches at fixed paths inside the checkout (the
    port's build/ directory holds its nvcc and g++ outputs already). The
    program's host threads are left at their defaults, as its runners
    leave them. Call before torch is imported."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(build, sub)


class Run:
    """What one run measured; the metric readers take it."""

    def __init__(self, cell, workload, config, traffic, seed, seconds):
        self.cell, self.workload, self.config, self.traffic = cell, workload, config, traffic
        self.seed, self.seconds = seed, seconds
        self.frame_s = []          # latency of each frame finished in the window
        self.failed = 0            # of them, frames that returned no pose
        self.window_s = seconds
        self.setup_s = None
        self.setup_parts = {}
        self.episodes = 0          # episodes finished in the window
        self.spans = None          # harness.spans.Spans (traced runs)
        self.trace = None          # harness.trace.Trace (traced runs)
        self.window_frames = []    # (t0, t1) perf_counter s around each feed.track in the window
        self.launches_window = {}  # row_top2 launches by (NA, NB, D) in the window
        self.slice_launches = []   # ... in each traced slice
        self.detail = {}           # what each check kind reports beside its numbers
        self.feed = None


def merged(base, over):
    """`base` with the keys of `over` replaced, recursing into dicts."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def compare(checks, cap, feed, R, device, control=False):
    """The check's numbers from the window's samples, kind by kind, and
    lost_frames (frames with no pose) for every cell; with `control`, the
    reference computed with TF32 on stands in for the program, in the
    numbers that have such a control."""
    numbers = {}
    for kind, mod in checks.items():
        numbers.update(mod.numbers(cap.samples(kind), R, feed, device, control))
    if not control:
        numbers["lost_frames"] = float(R.failed)
    return numbers


class Slices:
    """Start and stop the device trace at frame boundaries so that it
    covers the workload's `trace_slices`: [start, length] pairs as shares
    of the window, spread over it. `counts()` (the program's row_top2
    launches by shape) is read at each slice's start and stop, into
    `launches`: the launches of each slice."""

    def __init__(self, tracer, spans, slices, seconds, counts):
        self.tracer, self.spans, self.counts = tracer, spans, counts
        self.todo = [(a * seconds, (a + b) * seconds) for a, b in slices]
        self.launches, self._at_start = [], None

    def step(self, now):
        """Called between frames with the seconds since the window opened."""
        if self.spans.marking and now >= self.todo[0][1]:
            self._stop()
            self.todo.pop(0)
        if not self.spans.marking and self.todo and now >= self.todo[0][0]:
            self.tracer.start(len(self.spans.boundaries))
            self._at_start = self.counts()
            self.spans.marking = True

    def _stop(self):
        end = self.counts()
        self.launches.append({k: n - self._at_start.get(k, 0) for k, n in end.items()
                              if n > self._at_start.get(k, 0)})
        self.spans.marking = False
        self.tracer.stop(len(self.spans.boundaries))

    def close(self):
        if self.spans.marking:
            self._stop()


def run(cell, seed, seconds, trace, device=None, setup_start=None, log=print, overrides=None,
        control=False, run_out=None):
    """Measure one cell once. Returns (result dict, check table); raises
    RunError where no result may be printed. `device` and `overrides`
    ({"config"|"traffic"|"workload": keys to replace}) are for tests on the
    CPU at a small size, `control` also judges the TF32 control on the
    window's samples (into run_out["control"]); the command line passes none
    of them."""
    import torch

    setup_start = time.perf_counter() if setup_start is None else setup_start
    over = overrides or {}
    wl = merged(load_json("workloads", cell + ".json"), over.get("workload"))
    cfg = merged(load_json("configs", wl["config"] + ".json"), over.get("config"))
    tr = merged(load_json("traffic", wl["traffic"] + ".json"), over.get("traffic"))
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: load_module("metrics", m["name"]) for m in cell_metrics(cell, section)}
    checks = {kind: load_module("checks", kind) for kind in wl["check"]["samples"]}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            raise RunError(f"{cell} needs {wl['chips']} CUDA device(s); "
                           f"torch.cuda.is_available()={torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    from hfnet_slam_torch.ops import bf_match

    from . import check as C

    R = Run(cell, wl, cfg, tr, seed, seconds)
    gen = load_module("generators", tr["generator"])
    feed = gen.Feed(cfg, tr, seed, device, R.setup_parts)
    R.feed = feed
    t = time.perf_counter()
    feed.warmup()
    sync()
    R.setup_parts["warmup_s"] = time.perf_counter() - t

    cap = C.Capture(seed, wl["check"]["samples"])
    saved = []
    for mod in checks.values():
        saved.extend(mod.hook(cap, R, feed))

    spans = tracer = slicer = None
    if trace:
        from .spans import Spans
        from .trace import Trace

        spans, tracer = Spans(fence=True), Trace()
        R.spans, R.trace = spans, tracer
        feed.attach_shared(spans)
        slicer = Slices(tracer, spans, wl.get("trace_slices", [[0.0, 1.0]]), seconds,
                        lambda: dict(bf_match.shape_launches))

    sync()
    bf_match.reset_counts()
    gc.collect()
    t_open = time.perf_counter()
    R.setup_s = t_open - setup_start
    cap.active = True
    if slicer is not None:
        slicer.step(0.0)
    end = t_open + seconds
    done = False
    system = None
    while not done and time.perf_counter() < end:
        system = feed.new_episode()
        feed.attach(system, spans)
        for i in range(feed.n_frames):
            t0 = time.perf_counter()
            out = feed.track(system, i)
            sync()
            t1 = time.perf_counter()
            R.window_frames.append((t0, t1))
            if t1 > end:
                done = True
                break
            R.frame_s.append(t1 - t0)
            R.failed += out[1] is None
            if slicer is not None:
                slicer.step(t1 - t_open)
        else:
            R.episodes += 1
        feed.detach(system)
    cap.active = False
    R.launches_window = dict(bf_match.shape_launches)
    if slicer is not None:
        slicer.close()
        R.slice_launches = slicer.launches
    for obj, name, fn in reversed(saved):
        setattr(obj, name, fn)
    if tracer is not None:
        tracer.read()
    if spans is not None:
        spans.restore()
    sync()
    found = forbidden_modules()
    if found:
        raise RunError(f"forbidden modules loaded in the run: {found}")
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del system
    feed.release()

    # ---- the comparison with the reference, after the window --------------------
    t_check = time.perf_counter()
    numbers = compare(checks, cap, feed, R, device)
    correct, table = C.judge(numbers, wl["check"]["limits"])
    if control:
        R.control_table = C.judge(dict(numbers, **compare(checks, cap, feed, R, device, True)),
                                  wl["check"]["limits"])[1]

    check_s = time.perf_counter() - t_check
    metrics = {}
    for m in cell_metrics(cell, section):
        v = readers[m["name"]].read(R)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(R.frame_s), "failed": R.failed,
              "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s()
        dev["window_s"] = tracer.window_s
        gaps = tracer.idle_gaps(spans.boundaries)
        result["breakdown"] = {"device_ops": tracer.by_name(10), "idle_gaps": gaps or []}
    result["checks"] = table
    log(f"setup parts (s): {json.dumps(R.setup_parts)} setup_s {R.setup_s}")
    log(f"samples: {len(R.frame_s)} frames in {seconds} s, {R.episodes} whole episodes, "
        f"checked {', '.join(f'{k} {len(cap.samples(k))}' for k in cap.res)} in {check_s:.2f} s; "
        f"detail: {json.dumps(R.detail)}")
    if tracer is not None:
        from . import program_trace

        groups = program_trace.frame_groups(R)
        log(f"program frames counted: {0 if groups is None else len(groups)} of "
            f"{len(R.window_frames)} window frames; row_top2 launches in each slice: "
            f"{[{'x'.join(map(str, k)): n for k, n in sl.items()} for sl in R.slice_launches]}")
        log(f"trace: {len(tracer.kernels)} device activities, {len(tracer.markers)} markers for "
            f"{len(spans.boundaries)} span boundaries, read in {tracer.read_s:.2f} s; "
            f"slices (start s, length s, idle %, markers, boundaries): "
            f"{json.dumps(tracer.slice_idle())}")
    if run_out is not None:
        run_out["run"], run_out["cap"] = R, cap
        if control:
            run_out["control"] = R.control_table
    return result, table


def main(argv=None):
    import argparse

    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        age = process_age()
    except (OSError, ValueError, IndexError):
        age = 0.0
    try:
        result, table = run(a.workload, a.seed, a.seconds, bool(a.trace),
                            setup_start=t_main - age)
    except RunError as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    for name, row in table.items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0
