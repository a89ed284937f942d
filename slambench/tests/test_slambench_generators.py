"""The frozen generators give the same inputs for the same seed, and other
inputs for another seed."""
import numpy as np
import torch

from slambench.frozen import selftrain
from slambench.frozen.synth import CylinderWorld

CAM = {"fx": 56.0, "fy": 56.0, "cx": 40.0, "cy": 30.0, "width": 80, "height": 60}


def test_cylinder_world_renders_alike():
    a, b = CylinderWorld(CAM, n_blobs=60), CylinderWorld(CAM, n_blobs=60)
    pa, pb = a.orbit_pose(7), b.orbit_pose(7)
    ia, da = a.render_rgbd(*pa)
    ib, db = b.render_rgbd(*pb)
    assert np.array_equal(ia, ib) and np.array_equal(da, db)
    assert ia.shape == (60, 80) and np.all(da > 0)
    ua, va = a.correspondences(pa, a.orbit_pose(9), da, 50, np.random.default_rng(3))
    ub, vb = b.correspondences(pb, b.orbit_pose(9), db, 50, np.random.default_rng(3))
    assert np.array_equal(ua, ub) and np.array_equal(va, vb) and len(ua) > 10


def test_weights_follow_the_seed():
    dev = torch.device("cpu")
    p1, p2 = selftrain.init_params(2 ** 31 + 9, dev), selftrain.init_params(2 ** 31 + 9, dev)
    p3 = selftrain.init_params(2 ** 31 + 10, dev)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["conv0.weight"], p3["conv0.weight"])
    assert float(p1["proj.bias"].abs().sum()) == 0.0


def test_training_follows_the_seed():
    world = CylinderWorld(CAM, n_blobs=200)
    dev = torch.device("cpu")
    p = selftrain.init_params(4, dev)
    a, sa = selftrain.train(world, p, 4, 3, 32, 4, 20, 0)
    b, sb = selftrain.train(world, p, 4, 3, 32, 4, 20, 0)
    assert sa["steps"] == 3 and sa["loss_first"] == sb["loss_first"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0.weight"], p["conv0.weight"])
    assert torch.equal(a["proj.weight"], p["proj.weight"])
