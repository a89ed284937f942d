"""The loop cell's check sees a broken timed path: the revisit on the CPU at
LOOP_SMALL's size holds its limits with the program as it is, and reads
`correct` false, one of the fault's numbers past its limit, with each fault
of slambench/faults.py planted underneath the harness: a tracking step that
returns its state unchanged or leaves out half of its keypoints, BAs that
return their problem, an OptimizeSim3 refinement skipped or its scale
altered, an essential-graph result not written back, a global BA not
written back, a correction dropped.

The fault that leaves an episode's second correction unwritten needs an
episode that corrects twice, which the small circuit does not: it is read
on the card at the cell's size (PERF.md), and the per-problem share it
turns on in test_slambench_loop_reference.py.

On the sound run, `sim3_excess` is not held to its limit: the program's
Sim3 refinement leaves part of a call's reducible cost that a damped
solver removes (on this seed, 10.6% of one call's), which is the open
fault of PERF.md section 7 that keeps the cell out of BENCHMARK.json. The
test holds instead each sampled answer to the program's own algorithm
written plainly (reference/loop.sim3_refine)."""
import pytest
import torch

from slambench.faults import FAULTS
from slambench.harness import core

from _small import REVISIT

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(seed=2 ** 31 + 41, box=None):
    name, over = REVISIT
    return core.run(name, seed, 20, False, device=CPU, overrides=over, log=lambda *a: None,
                    run_out=box)


def _watch_features(monkeypatch, seen):
    """Compare the feed's features before the warm-up and at its release:
    episodes must not write into the traffic."""
    real = core.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind == "generators":
            warmup, release = mod.Feed.warmup, mod.Feed.release

            def warm(self):
                seen["before"] = [tuple(x.clone() for x in f) for f in self.frames]
                warmup(self)

            def rel(self):
                seen["same"] = all(torch.equal(a, b) for f, g in zip(self.frames, seen["before"])
                                   for a, b in zip(f, g))
                release(self)

            mod.Feed.warmup, mod.Feed.release = warm, rel
        return mod

    monkeypatch.setattr(core, "load_module", load)


def test_revisit_sound_run_holds_its_limits(monkeypatch):
    seen = {}
    box = {}
    _watch_features(monkeypatch, seen)
    result, table = _run(box=box)
    for name, row in table.items():
        if name != "sim3_excess":
            assert row["value"] is not None and row["value"] <= row["limit"], (name, table)
    assert table["sim3_excess"]["value"] is not None
    sim3 = box["run"].detail["sim3"]
    assert sim3 and all(r[4] < 0.1 and r[5] == r[6] for r in sim3), sim3
    assert table["missed_loops"]["value"] == 0 and seen["same"]


@pytest.mark.parametrize("fault", sorted(set(FAULTS) - {"second_correction_not_written"}))
def test_revisit_fault_is_caught(monkeypatch, fault):
    plant, numbers = FAULTS[fault]
    plant(monkeypatch.setattr)
    result, table = _run()
    assert not result["correct"], table
    assert any(table[n]["value"] is None or table[n]["value"] > table[n]["limit"]
               for n in numbers), table
