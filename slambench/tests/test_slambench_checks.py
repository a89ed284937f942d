"""Checks found by name: on the small orbit, the kinds moved into
slambench/checks/ (extract, track_step, ba) give the parent's numbers on the
same samples, with and without the control; the program's frames counted
through the harness's window frames are the ones the harness's extract
spans counted before."""
import types

import pytest
import torch

from slambench.harness import core
from slambench.harness import program_trace as PT
from slambench.harness.spans import Spans

import _parent_check as P
from _small import ORBIT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 31


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _parent_frame_groups(run):
    """The parent's program_trace.frame_groups: the program's `frame` spans
    that contain one of the harness's `extract` spans."""
    extracts = sorted((a, b) for a, b, _ in run.spans.spans.get("extract", []))
    recs = [r for r in PT.RECORDER.records() if r.t1 is not None]
    out, j = [], 0
    for f in sorted((r for r in recs if r.name == "frame"), key=lambda r: r.t0):
        a, b = f.t0 * 1e-9, f.t1 * 1e-9
        while j < len(extracts) and extracts[j][0] < a:
            j += 1
        if j < len(extracts) and extracts[j][1] <= b:
            out.append(f)
    return out


@pytest.fixture(scope="module")
def orbit_run():
    """One small orbit run with the recorder on and unfenced extract spans
    beside the window frames."""
    extract_spans = Spans(fence=False)
    real = core.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind == "generators":
            attach = mod.Feed.attach

            def attach_spans(self, system, spans):
                attach(self, system, spans)
                extract_spans.wrap_call(system, "extractor", "extract")

            mod.Feed.attach = attach_spans
        return mod

    core.load_module = load
    PT.RECORDER.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        box = {}
        name, over = ORBIT
        result, table = core.run(name, SEED, 4, False, device=CPU, overrides=over, control=True,
                                 run_out=box, log=lambda *a: None)
        groups = PT.frame_groups(box["run"])
        old = _parent_frame_groups(types.SimpleNamespace(spans=extract_spans))
    finally:
        core.load_module = real
        torch.set_num_threads(n)
        PT.RECORDER.reset()
    return types.SimpleNamespace(result=result, table=table, box=box, groups=groups, old=old)


def test_moved_kinds_give_the_parents_numbers(orbit_run):
    cap, R = orbit_run.box["cap"], orbit_run.box["run"]
    feed = R.feed
    assert all(cap.samples(k) for k in ("extract", "track_step", "ba"))
    for control in (False, True):
        old = dict(P.extract_numbers(cap.samples("extract"), feed.ref_params, feed.ref_extractor,
                                     CPU, control),
                   **P.track_numbers(cap.samples("track_step"), control))
        if not control:
            old.update(P.ba_numbers(cap.samples("ba"), R.config["camera"]))
        table = orbit_run.box["control"] if control else orbit_run.table
        assert {k: table[k]["value"] for k in old} == old, control


def test_window_frames_count_the_frames_the_extract_spans_counted(orbit_run):
    R = orbit_run.box["run"]
    assert orbit_run.groups and len(orbit_run.groups) == len(R.window_frames)
    assert [f.idx for f, _ in orbit_run.groups] == [f.idx for f in orbit_run.old]
