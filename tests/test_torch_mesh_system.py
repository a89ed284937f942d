"""The port's meshed system end to end, mirroring tests/test_mesh_system.py:
SLAMSystem.install_mesh on an 8-shard CPU mesh, through the SMALL loop
circuit, against the same run unmeshed: the loop closes in both, the
distributed global BA and the sharded retrieval cache ran only in the
meshed run, and distribution does not change the result's class (ATE and
keyframe count)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

pytestmark = pytest.mark.slow  # two loop circuits on the CPU, as its reference

from hfnet_slam_torch.parallel.multihost import Mesh  # noqa: E402
from hfnet_slam_torch.scenes import LOOP_SMALL, loop_system  # noqa: E402
from hfnet_slam_torch.slam.tracking import OK  # noqa: E402
from _torch_parity import run_loop  # noqa: E402


def _run(meshed: bool):
    sys_, ext = loop_system(LOOP_SMALL, "cpu")
    if meshed:
        # thresholds low enough that this sequence crosses them
        sys_.install_mesh(Mesh(torch.device("cpu"), 8), dist_min_kfs=12, retrieval_min_kfs=16)
    try:
        pre, post, n = run_loop(sys_, ext, LOOP_SMALL)
        sys_.finish()
        return {"state": sys_.tracker.state, "ate": post,
                "corrected": sys_.loop_closer.stats["corrected"],
                "dist_gba_runs": sys_.mapper.stats.get("dist_gba", 0),
                "retrieval_cache": getattr(sys_.store, "_retrieval_cache", None),
                "n_kf": int(sys_.store.kf_valid.sum())}
    finally:
        sys_.shutdown()


@pytest.fixture(scope="module")
def runs():
    return _run(meshed=True), _run(meshed=False)


def test_meshed_system_tracks_and_closes_loop(runs):
    meshed, unmeshed = runs
    assert meshed["state"] == OK
    assert meshed["corrected"] >= 1 and unmeshed["corrected"] >= 1


def test_meshed_paths_actually_ran(runs):
    meshed, unmeshed = runs
    assert meshed["dist_gba_runs"] >= 1 and meshed["retrieval_cache"] is not None
    assert unmeshed["dist_gba_runs"] == 0 and unmeshed["retrieval_cache"] is None


def test_meshed_parity_with_unmeshed(runs):
    meshed, unmeshed = runs
    path = LOOP_SMALL["total_angle"] * 6.0
    assert meshed["ate"] < 0.05 * path, meshed["ate"]
    assert meshed["ate"] < max(2.5 * unmeshed["ate"], 0.05 * path)
    assert abs(meshed["n_kf"] - unmeshed["n_kf"]) <= \
        max(5, 0.4 * max(meshed["n_kf"], unmeshed["n_kf"]))
