"""Deep-feature SLAM on PyTorch and CUDA (NVIDIA Hopper).

The port of `hfnet_slam_tpu` (the JAX reference, which stays beside it
unchanged). It mirrors the reference's layout so each counterpart is easy to
find, and imports neither `jax` nor any module of the reference:

  lie.py          -- SO3/SE3/Sim3 exp/log, retraction, orthonormalization
  geometry/       -- cameras, triangulation, two-view initialization
  models/         -- HF-Net (MobileNetV2 + NetVLAD), the pyramid extractor,
                     the Features record and the deterministic fake extractor
  ops/            -- keypoint selection and descriptor sampling, descriptor
                     matching, retrieval scores; the brute-force matcher
                     kernel
  optim/          -- pose-only LM, Schur-complement bundle adjustment, PnP
                     and Sim3 RANSAC, the Sim3 pose graph
  slam/           -- map store, device mirrors, tracking and relocalization,
                     local mapping, retrieval, loop closing, merging, the
                     async mapping/loop/GBA workers, atlas, facade
  native/         -- C++ host runtime (covisibility bookkeeping) via ctypes
  csrc/           -- hand-written CUDA kernels (built with nvcc at first use)
  evaluation/     -- ATE (Horn alignment)
  utils/          -- trajectory savers and recovery, settings files, dataset
                     readers (with a PNG codec), timing, pipelined
                     (prefetched) extraction
  examples/       -- the EuRoC runner
  convert.py      -- HF-Net weights, map and tracker state carried over from
                     the reference

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
CUDA device they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"
