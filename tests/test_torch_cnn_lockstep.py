"""The async CNN RGB-D path of the port against the JAX reference, lockstep
(finish() after every frame), both fed the same features.

The port's HF-Net is fine-tuned briefly on the CPU at CNN_SMALL's world
(320x240), 40 frames are extracted once, and each frame's Features (as
numpy) and keypoint depth go through both packages' track_features with
scenes.cnn_spec's configuration (async mapping on, loop closing off) at
small caps. That takes the extractor out of the comparison and leaves the
tracker's and the mapper's logic.

With learned descriptors the two runs part within a few frames at a float32
near-tie, and from there drift apart as any two float32 runs of a chaotic
system do. Two such ties, inspected: a keypoint 63.99976 px^2 (float64) from
its 8 px search window's edge, where float32's |a|^2 + |b|^2 - 2ab form of
the distance errs by ~0.03; a pose-LM residual whose float64 chi2 is 7.8191
against the 7.815 gate, which the JAX package itself puts on either side,
jitted and eager. So the comparison is made where it is exact:
  * every frame's fused track_step of the port, given the reference's own
    inputs of that frame, returns the reference's observations but for at
    most MAX_TIE_SLOTS slots, and exactly on at least MIN_EXACT_SHARE of the
    frames;
  * every frame's keyframe decision of the port equals the reference's
    _need_new_keyframe computed on the port's own state;
and over the whole run: the same tracking state at every frame, keyframe
counts within KF_SLACK, ATE <= max(2 x reference, 0.01 m)
(tests/test_torch_async.py's bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

N_FRAMES = 40
TRAIN_STEPS = 40
PAD = 512
TOL_POSE = 1e-4
MAX_TIE_SLOTS = 3
MIN_EXACT_SHARE = 0.75
KF_SLACK = (3, 0.25)  # |port - reference| <= max(3, 0.25 x reference)


def _system(pkg, cam_px, size):
    from hfnet_slam_torch.scenes import cnn_spec

    if pkg == "tpu":
        from hfnet_slam_tpu.geometry import cameras
        from hfnet_slam_tpu.slam.local_mapping import MapperConfig
        from hfnet_slam_tpu.slam.system import SLAMSystem, SystemConfig
        from hfnet_slam_tpu.slam.tracking import TrackerConfig
        kw = {}
    else:
        from hfnet_slam_torch.geometry import cameras
        from hfnet_slam_torch.slam.local_mapping import MapperConfig
        from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
        from hfnet_slam_torch.slam.tracking import TrackerConfig
        kw = {"device": "cpu"}
    sp = cnn_spec(PAD, k_max=64, m_max=8192)
    cfg = SystemConfig(**sp["system"], tracker=TrackerConfig(**sp["tracker"]),
                       mapper=MapperConfig(**sp["mapper"]))
    cam = cameras.pinhole(*cam_px[:4], size["width"], size["height"], **kw)
    return SLAMSystem(cam, None, cfg, **kw)


def _port_step_on(ref_call):
    """The port's track_step on a reference track_step call's inputs:
    (observation slots that differ, largest |stats difference|)."""
    from hfnet_slam_torch.slam import fused as TF

    ref_in, ref_out = ref_call
    args = [torch.as_tensor(np.array(x)) if hasattr(x, "shape") else x for x in ref_in]
    for i in (12, 13):  # the id vectors index in int64
        args[i] = args[i].long()
    args[-1] = TF.FusedConfig(*ref_in[-1])
    out = {k: v.numpy() for k, v in TF.track_step(*args).items()}
    slots = (out["obs"] != ref_out["obs"]) | (out["obs1"] != ref_out["obs1"])
    return int(slots.sum()), int(np.abs(out["stats"] - ref_out["stats"]).max())


@pytest.fixture(scope="module")
def lockstep():
    """Both packages frame by frame on the same features: each frame's
    record, the first frame at which they differ, the port's track_step on
    each reference track_step call's inputs, and the replayed keyframe
    decisions."""
    from hfnet_slam_tpu.models.extractor import Features as JFeatures
    from hfnet_slam_tpu.slam import fused as JF
    from hfnet_slam_tpu.slam.tracking import Tracker as JTracker
    from hfnet_slam_torch.models import selftrain as TS
    from hfnet_slam_torch.models.extractor import Features, HFExtractor
    from hfnet_slam_torch.ops import stereo as S
    from hfnet_slam_torch.scenes import CNN_SMALL, cnn_world
    from hfnet_slam_torch.slam import fused as TF
    from hfnet_slam_torch.slam.tracking import Tracker as TTracker

    size = CNN_SMALL
    world = cnn_world(size, "cpu")
    net, stats = TS.train(world, n_steps=TRAIN_STEPS, n_pairs=96, pose_range=N_FRAMES,
                          n_frames_cache=10, device="cpu")
    ext = HFExtractor(net, (size["height"], size["width"]), n_features=size["n_features"],
                      n_levels=size["n_levels"], pad_to=PAD, threshold=0.003, device="cpu")
    frames = []
    for i in range(N_FRAMES):
        img, dep = world.render_rgbd(*world.orbit_pose(i))
        f = ext(img)
        frames.append((tuple(x.numpy() for x in f),
                       S.depth_at_keypoints(torch.as_tensor(dep), f.xy, 1.0).numpy()))

    last = {}
    saved = (JF.track_step, TF.track_step, TTracker._need_new_keyframe)

    def spy(mod, key):
        real = getattr(mod, "track_step")

        def run(*a, **k):
            out = real(*a, **k)
            last[key] = (a, {n: np.asarray(v) for n, v in out.items()})
            return out
        mod.track_step = run

    decisions = []

    def replayed(self, frame):
        keep = (self.frames_since_kf, getattr(self.mapper, "abort_ba", None))
        want = JTracker._need_new_keyframe(self, frame)
        self.frames_since_kf = keep[0]
        if self.mapper is not None:
            self.mapper.abort_ba = keep[1]
        got = saved[2](self, frame)
        decisions.append((bool(want), bool(got)))
        return got

    px = world.cam.params.numpy()
    sys_j, sys_t = _system("tpu", px, size), _system("torch", px, size)
    spy(JF, "tpu")
    spy(TF, "torch")
    TTracker._need_new_keyframe = replayed
    rec = {"tpu": [], "torch": []}
    first, on_ref_inputs = None, []
    try:
        for i, (f, d) in enumerate(frames):
            last.clear()
            for key, sys_, feats in (("tpu", sys_j, JFeatures(*f)),
                                     ("torch", sys_t, Features(*(torch.as_tensor(x) for x in f)))):
                st, Re, te = sys_.track_features(feats, 0.05 * i, depth=d)
                sys_.finish()
                rec[key].append({
                    "state": int(st), "kfs": int(sys_.store.kf_valid.sum()),
                    "mps": int(sys_.store.mp_valid.sum()),
                    "centre": None if Re is None else -np.asarray(Re).T @ np.asarray(te)})
            if "tpu" in last:
                TF.track_step = saved[1]  # not recorded as the port's own call
                on_ref_inputs.append(_port_step_on(last["tpu"]))
                spy(TF, "torch")
            a, b = rec["tpu"][-1], rec["torch"][-1]
            same_step = ("tpu" in last) == ("torch" in last) and (
                "tpu" not in last or all(np.array_equal(last["tpu"][1][k], last["torch"][1][k])
                                         for k in ("obs", "obs1", "stats")))
            same_pose = (a["centre"] is None) == (b["centre"] is None) and (
                a["centre"] is None or np.abs(a["centre"] - b["centre"]).max() <= TOL_POSE)
            if first is None and not (same_step and same_pose and a["kfs"] == b["kfs"]
                                      and a["mps"] == b["mps"]):
                first = i
    finally:
        JF.track_step, TF.track_step, TTracker._need_new_keyframe = saved
        sys_j.shutdown()
        sys_t.shutdown()
    gt = [-world.orbit_pose(i)[0].T @ world.orbit_pose(i)[1] for i in range(N_FRAMES)]
    return {"rec": rec, "first": first, "on_ref_inputs": on_ref_inputs,
            "decisions": decisions, "gt": gt, "train": stats}


def test_track_step_matches_reference_on_its_inputs(lockstep):
    steps = lockstep["on_ref_inputs"]
    exact = sum(1 for n, _ in steps if n == 0)
    print(f"runs identical through frame {lockstep['first']} (exclusive); the port's "
          f"track_step on the reference's inputs: {exact} of {len(steps)} frames exact, "
          f"differing slots {[n for n, _ in steps if n]}; training "
          f"{lockstep['train']['steps']} steps, loss {lockstep['train']['loss_first']:.3f} "
          f"-> {lockstep['train']['loss_last']:.3f}")
    assert len(steps) >= N_FRAMES - 2
    assert max(n for n, _ in steps) <= MAX_TIE_SLOTS, steps
    assert max(d for _, d in steps) <= MAX_TIE_SLOTS, steps
    assert exact >= MIN_EXACT_SHARE * len(steps), steps


def test_whole_run_keeps_the_reference_keyframe_logic(lockstep):
    from hfnet_slam_torch.evaluation import ate

    rec, gt = lockstep["rec"], lockstep["gt"]
    assert [r["state"] for r in rec["torch"]] == [r["state"] for r in rec["tpu"]]
    dec = lockstep["decisions"]
    assert len(dec) >= N_FRAMES - 2 and all(want == got for want, got in dec), dec
    kf_j, kf_t = rec["tpu"][-1]["kfs"], rec["torch"][-1]["kfs"]
    assert kf_t >= 3
    assert abs(kf_t - kf_j) <= max(KF_SLACK[0], KF_SLACK[1] * kf_j), (kf_t, kf_j)
    errs = {}
    for key in ("tpu", "torch"):
        ids = [i for i, r in enumerate(rec[key]) if r["centre"] is not None]
        errs[key] = ate.ate_rmse(np.array([rec[key][i]["centre"] for i in ids]),
                                 np.array([gt[i] for i in ids]), with_scale=False)
    print(f"keyframes port {kf_t}, reference {kf_j}; map points port {rec['torch'][-1]['mps']}, "
          f"reference {rec['tpu'][-1]['mps']}; ATE port {errs['torch']:.4f} m, reference "
          f"{errs['tpu']:.4f} m; {sum(g for _, g in dec)} keyframe decisions replayed")
    assert errs["torch"] <= max(2 * errs["tpu"], 0.01), errs
