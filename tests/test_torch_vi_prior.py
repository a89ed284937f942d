"""tests/test_vi_dropout.py's A/B of the marginalized LastFrame prior chain
(ConstraintPoseImu) against hard-fixed anchoring (vi_marg_prior=False) in
the port, at scenes.VI_SMALL's widths and that test's clock: frames after 52
of a 78-frame run track at least as accurately with the chained information
(the reference's bound: prior <= fixed x 1.05 + 5e-3 m, metric ATE)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import VI_DROPOUT, VI_SMALL, build_vi, drive_vi  # noqa: E402
from hfnet_slam_torch.evaluation import ate  # noqa: E402


def test_marginal_prior_is_no_worse_than_fixed_anchoring():
    d = VI_DROPOUT
    errs = {}
    for label, use_prior in (("prior", True), ("fixed", False)):
        sys_, ext = build_vi("torch", VI_SMALL, device="cpu", vi_marg_prior=use_prior)
        _, est, gt, when = drive_vi(sys_, ext, [(i, False) for i in range(78)],
                                    d["frame_dt"], d["grav"])
        assert sys_.store.imu_initialized
        late = when > 52
        errs[label] = float(ate.ate_rmse(est[late], gt[late], with_scale=False))
        sys_.shutdown()
    assert errs["prior"] <= errs["fixed"] * 1.05 + 5e-3, errs
    assert np.isfinite(list(errs.values())).all()
