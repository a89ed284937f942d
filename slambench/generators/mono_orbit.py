"""Traffic generator: a monocular camera on the orbit inside a CylinderWorld,
its grey frames handed to the program's SLAMSystem.track_monocular, each
episode a new system that first initializes a map from two views.

Set-up: HF-Net's weights at the configuration's width (frozen/selftrain_dm:
initialized on the card from the configuration's init seed, then fine-tuned
on views of the episodes' pose range with pairs drawn from its pairs seed,
the descriptor on exact correspondences and, with the `train` key `det`,
the detector on the wall's exact keypoints at every pyramid level: the
configuration's checkpoint, the same in every run), every episode's
frames rendered grey on the host, and the program's network built at that
width (HFNet.from_state(..., depth_multiplier=...)) behind its HFExtractor.
A program whose HFNet takes no width cannot run the cell and stops here. The
run's seed sets the order in which the episodes (one a start phase) are
replayed, so every seed runs the same frames in another order. Warm-up
tracks `warmup_frames` frames of a first episode, its initialization
included.

Each window episode is a new SLAMSystem on the same extractor and camera
with an empty map: `new_episode()` tracks its first `init_frames` frames
(inside the timed window, outside the harness's frame latencies) and
records each one's host clock (t0, t1) and whether the episode then has a
map (`init_log`); `track(system, i)` tracks frame init_frames + i.

Traffic keys: phases (each episode's first orbit frame), frames (episode
length, initialization included), init_frames, dt (seconds between frames),
warmup_frames, path (CylinderWorld.orbit_pose's keyword arguments: rate,
orbit_radius, bob).
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from ..frozen import selftrain_dm
from ..frozen.synth import CylinderWorld
from ..harness.core import RunError
from ..reference import hfnet_dm as RD


class Feed:
    def __init__(self, config, traffic, seed, device, parts):
        from hfnet_slam_torch.geometry import cameras
        from hfnet_slam_torch.models.extractor import HFExtractor
        from hfnet_slam_torch.models.hfnet import HFNet

        if "depth_multiplier" not in inspect.signature(HFNet).parameters:
            raise RunError("the program's HFNet has no depth_multiplier: it cannot build the "
                           "configuration's network")
        self.cfg, self.tr, self.device = config, traffic, device
        e = config["extractor"]
        self.depth_multiplier = float(e["depth_multiplier"])
        self.init_frames = int(traffic["init_frames"])
        self.n_frames = int(traffic["frames"]) - self.init_frames
        self.dt = float(traffic["dt"])
        self.init_log = []     # a dict a window episode: its init frames' (t0, t1), has a map
        cam = config["camera"]
        t = time.perf_counter()
        world = CylinderWorld(cam, **config["world"])
        path = dict(traffic.get("path", {}))

        def pose(i):
            return world.orbit_pose(i, **path)

        phases = [int(p) for p in traffic["phases"]]
        rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
        self.order = [phases[j] for j in rng.permutation(len(phases))]
        self._next = 0
        parts["world_s"] = time.perf_counter() - t

        t = time.perf_counter()
        tc = e["train"]
        frames = int(traffic["frames"])
        lo, hi = min(phases), max(phases) + frames
        params = selftrain_dm.init_params(tc["init_seed"], device, self.depth_multiplier)
        # the detector term trains at every level of the extractor's pyramid
        levels = (RD.R.level_shapes((cam["height"], cam["width"]), e["n_levels"],
                                    e["scale_factor"]) if tc.get("det") else None)
        self.ref_params, stats = selftrain_dm.train(
            world, params, tc["pairs_seed"], tc["n_steps"], tc["n_pairs"], tc["n_frames_cache"],
            pose_range=hi - lo, pose_offset=lo, depth_multiplier=self.depth_multiplier,
            pose=pose, lr=tc["lr"], gap=tuple(tc["gap"]), det=tc.get("det"), levels=levels)
        del params
        parts["weights_s"] = time.perf_counter() - t
        parts["train_loss_first_last"] = [stats["loss_first"], stats["loss_last"]]
        parts["det_loss_last"] = stats["det_loss_last"]

        t = time.perf_counter()
        self.frames = {p: [world.render_rgbd(*pose(p + i))[0] for i in range(frames)]
                       for p in phases}
        parts["render_s"] = time.perf_counter() - t

        self.ref_extractor = {k: e[k] for k in ("n_features", "n_levels", "scale_factor",
                                                "threshold", "pad_to", "nms_radius")}
        self.image_hw = (cam["height"], cam["width"])
        self.cam = cameras.pinhole(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"],
                                   cam["height"], device=device)
        # the program gets its own copy of the weights: it never writes the
        # reference's
        net = HFNet.from_state({k: v.clone() for k, v in self.ref_params.items()}, device,
                               depth_multiplier=self.depth_multiplier)
        self.extractor = HFExtractor(net, self.image_hw, **self.ref_extractor, device=device)

    def _system(self):
        from hfnet_slam_torch.slam.local_mapping import MapperConfig
        from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
        from hfnet_slam_torch.slam.tracking import TrackerConfig

        c = self.cfg
        sc = SystemConfig(**c["system"], tracker=TrackerConfig(**c["tracker"]),
                          mapper=MapperConfig(**c["mapper"]))
        return SLAMSystem(self.cam, self.extractor, sc, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _track(self, system, j):
        return system.track_monocular(self.frames[system.phase][j], self.dt * j)

    def warmup(self):
        s = self._system()
        s.phase = self.order[0]
        for j in range(int(self.tr["warmup_frames"])):
            self._track(s, j)
        s.shutdown()

    def new_episode(self):
        """A new system on the next start phase of the seed's order, its
        first init_frames frames tracked."""
        s = self._system()
        s.phase = self.order[self._next % len(self.order)]
        self._next += 1
        frames = []
        for j in range(self.init_frames):
            t0 = time.perf_counter()
            self._track(s, j)
            self._sync()
            frames.append((t0, time.perf_counter()))
        self.init_log.append({"frames": frames, "has_map": int(s.store.kf_valid.sum()) > 0})
        return s

    def track(self, system, i):
        return self._track(system, self.init_frames + i)

    def attach_shared(self, spans):
        """Spans around the network's calls (shared by every episode): the
        level-0 forward (with the global head) and the other levels'
        backbone and local heads, each with its input's (h, w)."""
        net = self.extractor.net

        def hw(args):
            return tuple(args[0].shape[1:3])

        spans.wrap(net, "forward", "hfnet", info=lambda a: ("global",) + hw(a))
        spans.wrap(net, "backbone_local", "hfnet", info=lambda a: ("local",) + hw(a))
        spans.wrap(net, "local_head", "hfnet", info=lambda a: ("heads",))

    def attach(self, system, spans):
        if spans is not None:
            spans.wrap_call(system, "extractor", "extract")
            spans.wrap(system.tracker, "track", "track")
            spans.wrap(system.mapper, "process_keyframe", "mapping")

    def detach(self, system):
        system.shutdown()

    def frame_flops(self):
        """HF-Net forward FLOPs of one frame at the configuration's width:
        level 0 with the global head, the other levels' local branch."""
        return RD.frame_cost(self.image_hw, self.ref_extractor, self.depth_multiplier)["flops"]

    def release(self):
        self.frames = None
        self.extractor = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
