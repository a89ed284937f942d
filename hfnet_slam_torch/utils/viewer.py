"""Offline map/trajectory viewer and the live stepping hook.

In place of the reference's Pangolin GUI (src/{Viewer,FrameDrawer,
MapDrawer}.cc: keyframes, covisibility graph, landmarks, current camera),
`render(store, trajectory, path)` writes a PNG of the map state.
matplotlib is imported when render runs, not with this module, so the
module loads where matplotlib is not installed.

`LiveViewer` keeps the viewer's two control roles without a GUI:
re-rendering every few keyframes while the system runs (Viewer::Run's
refresh loop) and step-by-step execution (Tracking::SetStepByStep, the
"Step" menu button): with the gate armed the tracker blocks at each frame
until `step()` is called, so a driver (REPL, debugger, test) can
single-step the pipeline. Attach it as `system.viewer = LiveViewer(...)`;
SLAMSystem.track_features calls `on_frame` first on every frame.
"""
from __future__ import annotations

import threading

import numpy as np


def render(store, trajectory=None, path=None, show_covis=True, max_points=20000, elev=-60,
           azim=-90):
    """Render the map (landmarks, keyframes, spanning tree and loop edges,
    the per-frame trajectory) to `path` (PNG). Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")

    mp = store.mp_pos[store.mp_valid]
    if len(mp) > max_points:
        mp = mp[:: len(mp) // max_points + 1]
    if len(mp):
        ax.scatter(mp[:, 0], mp[:, 1], mp[:, 2], s=0.5, c="#888888", alpha=0.5)

    kfs = store.valid_kf_ids()
    if len(kfs):
        centers = np.stack([-store.kf_R[k].T @ store.kf_t[k] for k in kfs])
        ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=12, c="#1f77b4", marker="s",
                   label="keyframes")
        loc = {int(k): i for i, k in enumerate(kfs)}
        if show_covis:
            for i, k in enumerate(kfs):
                p = int(store.kf_parent[k])
                if p in loc:
                    q = centers[loc[p]]
                    ax.plot([centers[i, 0], q[0]], [centers[i, 1], q[1]],
                            [centers[i, 2], q[2]], c="#2ca02c", lw=0.8)
            for a, b in store.loop_edges:
                if int(a) in loc and int(b) in loc:
                    pa, pb = centers[loc[int(a)]], centers[loc[int(b)]]
                    ax.plot([pa[0], pb[0]], [pa[1], pb[1]], [pa[2], pb[2]], c="#d62728",
                            lw=1.5)

    if trajectory:
        tc = np.stack([-R.T @ t for _, R, t in trajectory])
        ax.plot(tc[:, 0], tc[:, 1], tc[:, 2], c="#ff7f0e", lw=1.2, label="trajectory")

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=elev, azim=azim)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


class LiveViewer:
    """Frame hook for a running SLAMSystem (`system.viewer = LiveViewer()`).

    - re-renders the map every `every_kf` new keyframes;
    - `set_step_by_step(True)` makes `on_frame` block until `step()` (or
      `release()`), as Tracking::mbStep gates the tracker.
    """

    def __init__(self, out_path="slam_view.png", every_kf: int = 10, render_kwargs=None):
        self.out_path = out_path
        self.every_kf = max(1, int(every_kf))
        self.render_kwargs = render_kwargs or {}
        self.frames = 0
        self.renders = 0
        self._last_kf_count = 0
        self._step_mode = False
        self._steps = 0
        self._released = False
        self._cv = threading.Condition()

    def set_step_by_step(self, flag: bool):
        with self._cv:
            self._step_mode = bool(flag)
            self._cv.notify_all()

    def step(self, n: int = 1):
        """Let n more frames through."""
        with self._cv:
            self._steps += n
            self._cv.notify_all()

    def release(self):
        """Unblock for good (viewer shutdown)."""
        with self._cv:
            self._released = True
            self._cv.notify_all()

    def _gate(self):
        """Block while step-by-step mode is armed and no step remains."""
        with self._cv:
            while self._step_mode and self._steps <= 0 and not self._released:
                self._cv.wait(timeout=0.1)
            if self._steps > 0:
                self._steps -= 1

    def on_frame(self, store, tracker):
        self.frames += 1
        self._gate()
        n_kf = int(store.kf_valid.sum())
        if n_kf - self._last_kf_count >= self.every_kf:
            self._last_kf_count = n_kf
            try:
                render(store, getattr(tracker, "trajectory", None), self.out_path,
                       **self.render_kwargs)
                self.renders += 1
            except Exception:
                pass  # rendering must never take down tracking
