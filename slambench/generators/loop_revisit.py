"""Traffic generator: a monocular camera on the loop circuit, facing out at
a landmark ring, its frozen synthetic features handed to the program's
SLAMSystem.track_features, so that the place first seen comes into view
again and loop closing finds and corrects it.

Set-up: the features of every frame up to the episode's end (frozen/ring.py;
their pixel and descriptor noise from the run's seed, one generator in
frame order), uploaded to the card in one call a field; then one new
synchronous SLAMSystem tracks the circuit's first `snapshot_frames` frames
and is kept as the snapshot (the map a revisit starts from). Warm-up runs
`warmup_episodes` whole episodes, each from a copy of the snapshot: the
first correction, with its first Sim3 and pose-graph solves, the first
global BA and the tracking step's graph capture, lies in set-up.

Each episode is a fresh copy of the snapshot (copy.deepcopy), tracking the
frames `episode` = [first, end) of the circuit, in which the first place
seen comes back into view: loop detection, a correction with its global BA
inline, and tracking in the corrected map. Every episode of a run replays
the same frames; the noise decides how many corrections an episode makes
(one or two on the seeds tried, PERF.md). The run's seed also draws the
check's samples.

Traffic keys: circuit_frames and laps (the circuit's length and the turns
it makes), dt (seconds between frames), snapshot_frames, episode,
warmup_episodes.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..frozen import ring


class Feed:
    def __init__(self, config, traffic, seed, device, parts):
        from hfnet_slam_torch.geometry import cameras
        from hfnet_slam_torch.models.extractor import Features

        self.cfg, self.tr, self.device = config, traffic, device
        lo, hi = (int(x) for x in traffic["episode"])
        self.first, self.n_frames = lo, hi - lo
        self.dt = float(traffic["dt"])
        n_circ = int(traffic["circuit_frames"])
        angle = 2.0 * np.pi * float(traffic["laps"])
        cam = config["camera"]

        t = time.perf_counter()
        world = ring.ring_world(**config["world"])
        make = ring.RingFeatures(world, cam, seed=seed, **config["features"])
        frames = [make(*ring.ring_pose(i, n_circ, angle)) for i in range(hi)]
        parts["features_s"] = time.perf_counter() - t

        t = time.perf_counter()
        fields = {k: torch.from_numpy(np.stack([f[k] for f in frames])).to(device)
                  for k in Features._fields}
        self.frames = [Features(*(fields[k][i] for k in Features._fields)) for i in range(hi)]
        self.cam = cameras.pinhole(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"],
                                   cam["height"], device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        parts["upload_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.snapshot = self._system()
        for i in range(int(traffic["snapshot_frames"])):
            self._track(self.snapshot, i)
        if device.type == "cuda":
            torch.cuda.synchronize()
        parts["snapshot_s"] = time.perf_counter() - t

    def _system(self):
        from hfnet_slam_torch.slam.local_mapping import MapperConfig
        from hfnet_slam_torch.slam.loop_closing import LoopCloserConfig
        from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
        from hfnet_slam_torch.slam.tracking import TrackerConfig

        c = self.cfg
        sc = SystemConfig(**c["system"], tracker=TrackerConfig(**c["tracker"]),
                          mapper=MapperConfig(**c["mapper"]), loop=LoopCloserConfig(**c["loop"]))
        return SLAMSystem(self.cam, None, sc, device=self.device)

    def _track(self, system, i):
        return system.track_features(self.frames[i], self.dt * i)

    def warmup(self):
        for _ in range(int(self.tr["warmup_episodes"])):
            s = self.new_episode()
            for i in range(self.n_frames):
                self.track(s, i)
            self.detach(s)

    def new_episode(self):
        """A fresh copy of the snapshot."""
        return copy.deepcopy(self.snapshot)

    def track(self, system, i):
        return self._track(system, self.first + i)

    def attach_shared(self, spans):
        """No network to wrap: the features are made in set-up."""

    def attach(self, system, spans):
        if spans is not None:
            spans.wrap(system.tracker, "track", "track")
            spans.wrap(system.mapper, "process_keyframe", "mapping")

    def detach(self, system):
        system.shutdown()

    def release(self):
        self.frames = None
        self.snapshot = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
