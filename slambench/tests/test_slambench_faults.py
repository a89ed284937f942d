"""The check sees a broken timed path: the cell's run on the CPU at a
small size, the program broken underneath the harness, reads `correct`
false; unbroken it reads true. The faults: a tracking step that returns
its incoming state, half of a batch left out, an answer altered where it
is produced, a local BA that returns its problem unchanged, a local BA
whose result never reaches the map, and frames that return no pose."""
import pytest
import torch

from slambench.harness import core

from _small import ORBIT

CPU = torch.device("cpu")


def _run(cell, seconds, seed=2 ** 31 + 11):
    name, over = cell
    return core.run(name, seed, seconds, False, device=CPU, overrides=over,
                    log=lambda *a: None)


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state_unchanged(monkeypatch):
    from hfnet_slam_torch.slam import fused

    real = fused.track_step

    def step(*args, **kw):
        out = real(*args, **kw)
        return dict(out, R=args[4].clone(), t=args[5].clone())

    monkeypatch.setattr(fused, "track_step", step)


def _extract_half(monkeypatch):
    from hfnet_slam_torch.models.extractor import HFExtractor

    real = HFExtractor.__call__

    def call(self, image):
        f = real(self, image)
        mask = f.mask.clone()
        mask[len(mask) // 2:] = False
        return f._replace(mask=mask)

    monkeypatch.setattr(HFExtractor, "__call__", call)


def _extract_altered(monkeypatch):
    from hfnet_slam_torch.models.extractor import HFExtractor

    real = HFExtractor.__call__

    def call(self, image):
        f = real(self, image)
        return f._replace(xy=f.xy + 0.5)

    monkeypatch.setattr(HFExtractor, "__call__", call)


def _ba_skipped(monkeypatch):
    from hfnet_slam_torch.optim import ba

    monkeypatch.setattr(ba, "bundle_adjust", lambda cam_kind, cam_params, prob, **kw: prob)


def _ba_not_written(monkeypatch):
    """The solve runs, but the map is left as the mapper found it."""
    from hfnet_slam_torch.slam.local_mapping import LocalMapper

    real = LocalMapper._run_ba

    def run_ba(self, *a, **kw):
        st = self.store
        saved = st.kf_R.copy(), st.kf_t.copy(), st.mp_pos.copy()
        out = real(self, *a, **kw)
        st.kf_R[:], st.kf_t[:], st.mp_pos[:] = saved
        return out

    monkeypatch.setattr(LocalMapper, "_run_ba", run_ba)


def _frames_lost(monkeypatch):
    from hfnet_slam_torch.slam.system import SLAMSystem

    real = SLAMSystem.track_rgbd
    calls = [0]

    def track(self, *a, **kw):
        out = real(self, *a, **kw)
        calls[0] += 1
        return (out[0], None) + tuple(out[2:]) if calls[0] % 5 == 0 else out

    monkeypatch.setattr(SLAMSystem, "track_rgbd", track)


def test_orbit_sound_run_is_correct():
    result, table = _run(ORBIT, 4)
    assert result["correct"], table


@pytest.mark.parametrize("fault", [_state_unchanged, _extract_half, _extract_altered,
                                   _ba_skipped, _ba_not_written, _frames_lost])
def test_orbit_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    result, table = _run(ORBIT, 4)
    assert not result["correct"], table
