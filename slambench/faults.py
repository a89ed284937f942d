"""Faults planted underneath the harness of the loop cell, by name: each
breaks the program in place through `patch(obj, attr, value)` (a test's
monkeypatch.setattr, or control.py's, which undoes them after the run).
The CPU tests plant them at a small size (tests/test_slambench_revisit.py);
`python3 slambench/control.py --fault NAME` reads them on the card at the
cell's own size."""


def step_state_unchanged(patch):
    """The tracking step returns the pose it started from."""
    from hfnet_slam_torch.slam import fused

    real = fused.track_step

    def step(*args, **kw):
        out = real(*args, **kw)
        return dict(out, R=args[4].clone(), t=args[5].clone())

    patch(fused, "track_step", step)


def step_half_masked(patch):
    """The tracking step leaves out the second half of the frame's keypoints."""
    from hfnet_slam_torch.slam import fused

    real = fused.track_step

    def step(*args, **kw):
        mask = args[17].clone()
        mask[len(mask) // 2:] = False
        return real(*args[:17], mask, *args[18:], **kw)

    patch(fused, "track_step", step)


def ba_skipped(patch):
    """Every BA returns its problem unchanged."""
    from hfnet_slam_torch.optim import ba

    patch(ba, "bundle_adjust", lambda cam_kind, cam_params, prob, **kw: prob)


def sim3_scale_altered(patch):
    """OptimizeSim3's answer comes out with its scale 5% off."""
    from hfnet_slam_torch.optim import sim3

    real = sim3.optimize_sim3

    def optimize_sim3(*a, **kw):
        out = real(*a, **kw)
        return dict(out, s12=out["s12"] * 1.05)

    patch(sim3, "optimize_sim3", optimize_sim3)


def sim3_skipped(patch):
    """OptimizeSim3 returns its start (no iteration), with the inliers there."""
    from hfnet_slam_torch.optim import sim3

    real = sim3.optimize_sim3
    patch(sim3, "optimize_sim3", lambda *a, **kw: real(*a, **dict(kw, n_iters=0)))


def pose_graph_not_written(patch):
    """The essential graph is solved, but its result never reaches the map."""
    from hfnet_slam_torch.slam.loop_closing import LoopCloser

    patch(LoopCloser, "_apply_pose_graph", lambda self, meta, out: None)


def gba_not_written(patch):
    """The global BA runs, but the map is left as the loop closer handed it
    over."""
    from hfnet_slam_torch.slam.local_mapping import LocalMapper

    real = LocalMapper.run_global_ba

    def run_global_ba(self, *a, **kw):
        st = self.store
        saved = st.kf_R.copy(), st.kf_t.copy(), st.mp_pos.copy()
        out = real(self, *a, **kw)
        st.kf_R[:], st.kf_t[:], st.mp_pos[:] = saved
        return out

    patch(LocalMapper, "run_global_ba", run_global_ba)


def second_correction_not_written(patch):
    """An episode's second correction solves its essential graph and runs its
    global BA, but neither result reaches the map; the first correction is
    written as it should be."""
    from hfnet_slam_torch.slam.local_mapping import LocalMapper
    from hfnet_slam_torch.slam.loop_closing import LoopCloser

    correct, apply, gba = (LoopCloser._correct_loop, LoopCloser._apply_pose_graph,
                           LocalMapper.run_global_ba)
    box = {"second": False}

    def _correct_loop(self, *a, **kw):
        box["second"] = self.stats["corrected"] == 1
        try:
            return correct(self, *a, **kw)
        finally:
            box["second"] = False

    def _apply_pose_graph(self, meta, out):
        if not box["second"]:
            apply(self, meta, out)

    def run_global_ba(self, *a, **kw):
        if not box["second"]:
            return gba(self, *a, **kw)
        st = self.store
        saved = st.kf_R.copy(), st.kf_t.copy(), st.mp_pos.copy()
        out = gba(self, *a, **kw)
        st.kf_R[:], st.kf_t[:], st.mp_pos[:] = saved
        return out

    patch(LoopCloser, "_correct_loop", _correct_loop)
    patch(LoopCloser, "_apply_pose_graph", _apply_pose_graph)
    patch(LocalMapper, "run_global_ba", run_global_ba)


def correction_dropped(patch):
    """A confirmed loop is never corrected."""
    from hfnet_slam_torch.slam.loop_closing import LoopCloser

    patch(LoopCloser, "_correct_loop", lambda self, *a, **kw: None)


# the numbers of which each fault must fail one
FAULTS = {"step_state_unchanged": (step_state_unchanged, ("pose_err",)),
          "step_half_masked": (step_half_masked, ("obs_mismatch",)),
          "ba_skipped": (ba_skipped, ("ba_excess",)),
          "sim3_scale_altered": (sim3_scale_altered, ("sim3_excess",)),
          "sim3_skipped": (sim3_skipped, ("sim3_excess",)),
          "pose_graph_not_written": (pose_graph_not_written, ("pg_excess",)),
          "gba_not_written": (gba_not_written, ("gba_excess",)),
          "second_correction_not_written": (second_correction_not_written,
                                            ("pg_excess", "gba_excess")),
          "correction_dropped": (correction_dropped, ("missed_loops",))}
