"""Shared scene and system builders for the port's parity tests
(tests/test_torch_*.py): the same numpy inputs go through the JAX reference
(hfnet_slam_tpu) and the PyTorch port (hfnet_slam_torch, device="cpu").
Both packages are built from the one scene definition,
`hfnet_slam_torch.scenes.browse_spec`."""
import numpy as np

from hfnet_slam_torch.scenes import PRODUCTION, SMALL, browse_pose, browse_spec  # noqa: F401


def build(pkg, device=None, size=SMALL):
    """(system, extractor) of package `pkg` ("tpu" or "torch") at `size`."""
    if pkg == "torch":
        from hfnet_slam_torch.scenes import browse_system
        return browse_system(size, device)
    from hfnet_slam_tpu.geometry import cameras
    from hfnet_slam_tpu.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig
    from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_tpu.slam.tracking import TrackerConfig
    sp = browse_spec(size)
    cam = cameras.pinhole(**sp["cam"])
    ext = FakeExtractor(SyntheticWorld.cloud(**sp["world"]), cam, **sp["ext"])
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    return SLAMSystem(cam, ext, cfg), ext


def run(sys_, ext, lo, hi, jolt_at=None):
    """Track frames [lo, hi). Returns (est centers, gt centers, tracked ids)."""
    est, gt, ids = [], [], []
    for i in range(lo, hi):
        R, t = browse_pose(i, jolt_at)
        _, Re, te = sys_.track_features(ext(R, t), 0.05 * i)
        if Re is not None:
            est.append(-np.asarray(Re).T @ np.asarray(te))
            gt.append(-R.T @ t)
            ids.append(i)
    return np.asarray(est), np.asarray(gt), ids
