"""The JAX reference's run of the VI_SMALL scene, in a process of its own so
that tests/test_torch_vi_slam.py can drive the port at the same time:

    python tests/_vi_reference_run.py OUT.npz

Writes the tracked frames' centres and ground truth, their ids, the states,
and the reference's IMU stage, init flag and map count to OUT.npz."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from _torch_parity import VI_SMALL, build_vi, drive_vi  # noqa: E402


def main(out):
    sys_, ext = build_vi("tpu", VI_SMALL)
    size = VI_SMALL
    states, est, gt, when = drive_vi(sys_, ext, [(i, False) for i in range(size["frames"])],
                                     size["frame_dt"], size["grav"])
    np.savez(out, states=np.asarray(states), est=est, gt=gt, when=when,
             stage=sys_.vi.stage, imu_initialized=sys_.store.imu_initialized,
             n_maps=sys_.atlas.n_maps())


if __name__ == "__main__":
    main(sys.argv[1])
