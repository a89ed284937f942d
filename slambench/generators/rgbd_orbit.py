"""Traffic generator: an RGB-D camera on an orbit inside a CylinderWorld,
its frames handed to the program's SLAMSystem.track_rgbd as a host grey
image and a host depth map in metres.

Set-up: HF-Net's weights (frozen/selftrain: initialized on the card from
the configuration's init seed, then fine-tuned on views of the whole pose
range with pairs drawn from its pairs seed: the configuration's
checkpoint, the same in every run), every episode's frames rendered on the
host, and the program's extractor built on the weights. The run's seed
sets the order in which the episodes (one a start phase) are replayed, so
every seed runs the same frames in another order. Each episode is a new
SLAMSystem on the same extractor and camera, tracking its frames from the
first.

Traffic keys: phases (each episode's first orbit frame), frames (episode
length), dt (seconds between frames), warmup_frames (frames of the first
episode tracked once in set-up, which runs cuDNN's first calls and the
first keyframes' shapes).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..frozen import selftrain
from ..frozen.synth import CylinderWorld


class Feed:
    def __init__(self, config, traffic, seed, device, parts):
        from hfnet_slam_torch.geometry import cameras
        from hfnet_slam_torch.models.extractor import HFExtractor
        from hfnet_slam_torch.models.hfnet import HFNet

        self.cfg, self.tr, self.device = config, traffic, device
        self.n_frames = int(traffic["frames"])
        cam = config["camera"]
        t = time.perf_counter()
        world = CylinderWorld(cam, **config["world"])
        phases = [int(p) for p in traffic["phases"]]
        rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
        self.order = [phases[j] for j in rng.permutation(len(phases))]
        self._next = 0
        parts["world_s"] = time.perf_counter() - t

        t = time.perf_counter()
        tc = config["extractor"]["train"]
        lo, hi = min(phases), max(phases) + self.n_frames
        params = selftrain.init_params(tc["init_seed"], device)
        self.ref_params, stats = selftrain.train(
            world, params, tc["pairs_seed"], tc["n_steps"], tc["n_pairs"], tc["n_frames_cache"],
            pose_range=hi - lo, pose_offset=lo, lr=tc["lr"], gap=tuple(tc["gap"]))
        del params
        parts["weights_s"] = time.perf_counter() - t
        parts["train_loss_first_last"] = [stats["loss_first"], stats["loss_last"]]

        t = time.perf_counter()
        self.frames = {p: [world.render_rgbd(*world.orbit_pose(p + i))
                           for i in range(self.n_frames)] for p in phases}
        parts["render_s"] = time.perf_counter() - t

        e = config["extractor"]
        self.ref_extractor = {k: e[k] for k in ("n_features", "n_levels", "scale_factor",
                                                "threshold", "pad_to", "nms_radius")}
        self.cam = cameras.pinhole(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"],
                                   cam["height"], device=device)
        # the program gets its own copy of the weights: it never writes the
        # reference's
        net = HFNet.from_state({k: v.clone() for k, v in self.ref_params.items()}, device)
        self.extractor = HFExtractor(net, (cam["height"], cam["width"]),
                                     **self.ref_extractor, device=device)

    def _system(self):
        from hfnet_slam_torch.slam.local_mapping import MapperConfig
        from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
        from hfnet_slam_torch.slam.tracking import TrackerConfig

        c = self.cfg
        sc = SystemConfig(**c["system"], tracker=TrackerConfig(**c["tracker"]),
                          mapper=MapperConfig(**c["mapper"]))
        return SLAMSystem(self.cam, self.extractor, sc, device=self.device)

    def warmup(self):
        s = self._system()
        s.phase = self.order[0]
        for i in range(int(self.tr["warmup_frames"])):
            self.track(s, i)
        s.shutdown()

    def new_episode(self):
        """A new system, tagged with the next start phase of the seed's order."""
        s = self._system()
        s.phase = self.order[self._next % len(self.order)]
        self._next += 1
        return s

    def track(self, system, i):
        img, dep = self.frames[system.phase][i]
        return system.track_rgbd(img, dep, self.tr["dt"] * i)

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
        """HF-Net forward FLOPs of one frame: level 0 with the global head,
        the other levels' local branch."""
        from ..reference import hfnet as RH

        e = self.ref_extractor
        shapes = RH.level_shapes((self.cfg["camera"]["height"], self.cfg["camera"]["width"]),
                                 e["n_levels"], e["scale_factor"])
        return sum(RH.forward_cost(h, w, i == 0)["flops"] for i, (h, w) in enumerate(shapes))

    def release(self):
        self.frames = None
        self.extractor = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
