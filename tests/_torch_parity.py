"""Shared scene and system builders for the port's parity tests
(tests/test_torch_*.py): the same numpy inputs go through the JAX reference
(hfnet_slam_tpu) and the PyTorch port (hfnet_slam_torch, device="cpu").
Both packages are built from the one scene definition in
`hfnet_slam_torch.scenes` (browse_spec, reloc_spec, loop_spec)."""
import numpy as np

from hfnet_slam_torch.scenes import (BLACKOUT, LOOP_PRODUCTION, LOOP_SMALL, PRODUCTION,  # noqa: F401
                                     SMALL, VI_DROPOUT, VI_SMALL, browse_pose, browse_spec,
                                     loop_spec, reloc_spec, ring_pose, ring_world, synth_imu,
                                     vi_blank_features, vi_frame_pose, vi_pose, vi_spec)


def T(x, dtype=None):
    """numpy (or a read-only jax array) -> a CPU torch tensor."""
    import torch
    return torch.as_tensor(np.array(x), dtype=dtype)


def cams():
    """The scenes' pinhole camera in both packages: (reference, port)."""
    from hfnet_slam_tpu.geometry import cameras as JC
    from hfnet_slam_torch.geometry import cameras as TC
    return (JC.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480),
            TC.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu"))


def gumbel_picks(key, valid, n_hyps, k):
    """The reference's in-graph RANSAC sampler (optim/sim3.py:95-97,
    optim/pnp.py:71-73) run on its own, so the port gets the same draws."""
    import jax
    import jax.numpy as jnp
    g = jax.random.gumbel(jnp.asarray(key, jnp.uint32), (n_hyps, len(valid)))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, k)[1])


def _jax_system(sp, world):
    from hfnet_slam_tpu.geometry import cameras
    from hfnet_slam_tpu.models.fake import FakeExtractor
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig
    from hfnet_slam_tpu.slam.loop_closing import LoopCloserConfig
    from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_tpu.slam.tracking import TrackerConfig
    cam = cameras.pinhole(**sp["cam"])
    ext = FakeExtractor(world, cam, **sp["ext"])
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]),
                       loop=LoopCloserConfig(**sp.get("loop", {})))
    return SLAMSystem(cam, ext, cfg), ext


def build(pkg, device=None, size=SMALL, spec=browse_spec, async_mapping=False):
    """(system, extractor) of package `pkg` ("tpu" or "torch") at `size`,
    configured by `spec` (browse_spec or reloc_spec), in the async pipeline
    when `async_mapping`."""
    if pkg == "torch":
        from hfnet_slam_torch.scenes import browse_system
        return browse_system(size, device, spec=spec, async_mapping=async_mapping)
    from hfnet_slam_tpu.models.fake import SyntheticWorld
    sp = spec(size)
    sp["system"]["async_mapping"] = async_mapping
    return _jax_system(sp, SyntheticWorld.cloud(**sp["world"]))


def build_loop(pkg, device=None, size=LOOP_SMALL, async_mapping=False):
    """(system, extractor) of the loop circuit of package `pkg` at `size`."""
    if pkg == "torch":
        from hfnet_slam_torch.scenes import loop_system
        return loop_system(size, device, async_mapping=async_mapping)
    from hfnet_slam_tpu.models.fake import SyntheticWorld
    sp = loop_spec(size)
    sp["system"]["async_mapping"] = async_mapping
    return _jax_system(sp, SyntheticWorld(*ring_world(**sp["world"])))


def run(sys_, ext, lo, hi, jolt_at=None, lockstep=False):
    """Track frames [lo, hi). Returns (est centers, gt centers, tracked ids).
    `lockstep` drains the async pipeline after every frame (finish())."""
    est, gt, ids = [], [], []
    for i in range(lo, hi):
        R, t = browse_pose(i, jolt_at)
        _, Re, te = sys_.track_features(ext(R, t), 0.05 * i)
        if lockstep:
            sys_.finish()
        if Re is not None:
            est.append(-np.asarray(Re).T @ np.asarray(te))
            gt.append(-R.T @ t)
            ids.append(i)
    return np.asarray(est), np.asarray(gt), ids


def run_loop(sys_, ext, size, n=None, lockstep=False):
    """Track the circuit's first n frames (all by default). Returns the
    scale-corrected ATE of the track-time poses (pre) and of the poses
    rebuilt through the final map's keyframes (post), bench.py's sync
    protocol, and the number of tracked frames. `lockstep` drains the async
    pipeline after every frame."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.utils import trajectory as TJ

    n = n or size["frames"]
    live, gt = [], []
    for i in range(n):
        R, t = ring_pose(i, size["frames"], size["total_angle"])
        _, Re, te = sys_.track_features(ext(R, t), 0.05 * i)
        if lockstep:
            sys_.finish()
        if Re is not None:
            live.append(-np.asarray(Re).T @ np.asarray(te))
            gt.append(-R.T @ t)
    pre = float(ate.ate_rmse(np.asarray(live), np.asarray(gt), with_scale=True))
    rec, _, _ = TJ.recovered_resolved(sys_.trajectory, store=sys_.store)
    rc, rg = [], []
    for ts, R_e, t_e in rec:
        R, t = ring_pose(int(round(ts / 0.05)), size["frames"], size["total_angle"])
        rc.append(-np.asarray(R_e).T @ np.asarray(t_e))
        rg.append(-R.T @ t)
    post = float(ate.ate_rmse(np.asarray(rc), np.asarray(rg), with_scale=True)) \
        if len(rc) > 20 else float("nan")
    return pre, post, len(live)


def build_vi(pkg, size=VI_SMALL, device=None, async_mapping=False, vi_marg_prior=True):
    """(system, extractor) of the visual-inertial scene of package `pkg` at
    `size`, from the one definition scenes.vi_spec."""
    if pkg == "torch":
        from hfnet_slam_torch.scenes import vi_system
        return vi_system(size, device, async_mapping=async_mapping, vi_marg_prior=vi_marg_prior)
    from hfnet_slam_tpu.geometry import cameras
    from hfnet_slam_tpu.geometry import imu as IMU
    from hfnet_slam_tpu.models.fake import FakeExtractor, SyntheticWorld
    from hfnet_slam_tpu.slam.local_mapping import MapperConfig
    from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_tpu.slam.tracking import TrackerConfig
    from hfnet_slam_tpu.slam.vi import VIConfig
    sp = vi_spec(size, async_mapping, vi_marg_prior)
    cam = cameras.pinhole(**sp["cam"])
    ext = FakeExtractor(SyntheticWorld.cloud(**sp["world"]), cam, **sp["ext"])
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]), vi=VIConfig(**sp["vi"]))
    return SLAMSystem(cam, ext, cfg, imu_calib=IMU.default_calib(**sp["imu"])), ext


def drive_vi(sys_, ext, frames, frame_dt, grav, blank=None, lockstep=False):
    """Track (i, blackout) frames of the VI scene with their exact IMU; a
    blackout frame gets `blank` features. Returns (states, est centres, gt
    centres, frame ids of tracked frames)."""
    states, est, gt, when = [], [], [], []
    for i, dark in frames:
        t = i * frame_dt
        R, tt = vi_frame_pose(t)
        feats = blank if dark else ext(R, tt)
        rows = synth_imu(t - frame_dt, t, grav) if i > 0 else None
        st, Re, te = sys_.track_features(feats, t, imu=rows)
        if lockstep:
            sys_.finish()
        states.append(st)
        if Re is not None:
            est.append(-np.asarray(Re).T @ np.asarray(te))
            gt.append(vi_pose(t)[1])
            when.append(i)
    return states, np.asarray(est), np.asarray(gt), np.asarray(when)


def vi_metrics(est, gt, when, after=60):
    """bench.py's _vi_metrics protocol over the frames after `after`:
    (|s - 1| of the Horn similarity alignment, the metric ATE without
    scale, the ground-truth path length)."""
    from hfnet_slam_torch.evaluation import ate
    late = when > after
    _, _, s = ate.align_horn(est[late], gt[late], with_scale=True)
    path = float(np.linalg.norm(np.diff(gt[late], axis=0), axis=1).sum())
    return (abs(float(s) - 1.0), float(ate.ate_rmse(est[late], gt[late], with_scale=False)),
            path)
