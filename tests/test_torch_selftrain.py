"""Parity of the port's self-supervised HF-Net fine-tune
(hfnet_slam_torch/models/selftrain.py) with the JAX reference's
(hfnet_slam_tpu/models/selftrain.py), on the CPU at 160x128, from shared
weights (the reference's init_params(PRNGKey(0)) carried across as numpy).

Tolerances (float32 convolutions and their backward summed in another
order):
  * one step's loss: TOL_LOSS relative;
  * every parameter's gradient: TOL_GRAD of that parameter's largest
    gradient magnitude;
  * the weights after one Adam step (optax.adam against torch.optim.Adam):
    TOL_WEIGHTS absolute;
  * five `train` steps from the same seed: the same pairs drawn, the same
    steps skipped, each loss within TOL_TRAIN relative.
Then tests/test_selftrain.py's loss-decrease check on the port alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hfnet_slam_tpu.geometry import cameras as JC  # noqa: E402
from hfnet_slam_tpu.models import hfnet as JH  # noqa: E402
from hfnet_slam_tpu.models import selftrain as JS  # noqa: E402
from hfnet_slam_tpu.models.synth import CylinderWorld as JWorld  # noqa: E402
from hfnet_slam_torch import convert  # noqa: E402
from hfnet_slam_torch.geometry import cameras as TC  # noqa: E402
from hfnet_slam_torch.models import hfnet as TH  # noqa: E402
from hfnet_slam_torch.models import selftrain as TS  # noqa: E402
from hfnet_slam_torch.models.synth import CylinderWorld as TWorld  # noqa: E402

TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_WEIGHTS = 1e-5
TOL_TRAIN = 1e-3
ADAM_FLAT = 1e-6
CAM = (112.0, 112.0, 80.0, 64.0, 160, 128)
HW = (128, 160)


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, JH.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def worlds():
    return (JWorld(JC.pinhole(*CAM), n_blobs=900, seed=5),
            TWorld(TC.pinhole(*CAM, device="cpu"), n_blobs=900, seed=5))


def _port_net(tree):
    return TH.HFNet.from_state(convert.hfnet_params_from_reference(tree), "cpu")


@pytest.fixture(scope="module")
def batch(worlds):
    """Views 0 and 4, 96 correspondences and both detector targets."""
    w = worlds[1]
    pa, pb = w.orbit_pose(0), w.orbit_pose(4)
    (ia, da), (ib, _) = w.render_rgbd(*pa), w.render_rgbd(*pb)
    ua, ub = w.correspondences(pa, pb, da, 160, np.random.default_rng(0))
    return ia, ib, ua[:96], ub[:96], w.corner_cells(*pa), w.corner_cells(*pb)


_REF_GRADS = {}


def _ref_grads(params, batch, det_weight):
    """The reference's (loss, gradient tree) of the batch, once per weight."""
    if det_weight not in _REF_GRADS:
        args = [jnp.asarray(x) for x in batch]
        _REF_GRADS[det_weight] = jax.value_and_grad(JS.loss_fn)(
            jax.tree.map(jnp.asarray, params), *args, HW, det_weight)
    return _REF_GRADS[det_weight]


def _port_grads(params, batch, det_weight):
    net = TS.trainable_copy(_port_net(params), "cpu")
    t = [torch.as_tensor(x) for x in batch]
    loss = TS.loss_fn(net, *t, HW, det_weight)
    loss.backward()
    return net, float(loss.detach())


def _ref_grad_by_port_key(g):
    return {pk: torch.as_tensor(np.ascontiguousarray(v))
            for pk, v in convert.hfnet_params_from_reference(
                jax.tree.map(np.asarray, g)).items()}


@pytest.mark.parametrize("det_weight", [0.0, 1.0])
def test_loss_and_gradients_match_reference(ref_params, batch, det_weight):
    loss_r, g_r = _ref_grads(ref_params, batch, det_weight)
    net, loss_p = _port_grads(ref_params, batch, det_weight)
    assert abs(loss_p - float(loss_r)) <= TOL_LOSS * abs(float(loss_r)), (loss_p, float(loss_r))
    g_r = _ref_grad_by_port_key(g_r)
    n_checked = 0
    for k, p in net.named_parameters():
        gr = g_r[k]
        if not p.requires_grad:
            assert float(gr.abs().max()) == 0.0, k  # the global head takes no gradient
            continue
        gp = torch.zeros_like(p) if p.grad is None else p.grad
        scale = float(gr.abs().max())
        err = float((gp - gr).abs().max())
        assert err <= TOL_GRAD * max(scale, 1e-30), (k, err, scale)
        n_checked += scale > 0
    # det_weight 0 leaves the detector head without gradient in both packages
    assert n_checked == (len(TS.local_parameters(net)) - (4 if det_weight == 0 else 0))


def test_detector_ce_matches_reference(ref_params, batch):
    """The detector loss alone (65-way CE, balanced corner / dustbin cells)."""
    ia, _, _, _, ta, _ = batch
    ref = JS.detector_ce(jax.tree.map(jnp.asarray, ref_params), jnp.asarray(ia),
                         jnp.asarray(ta))
    net = _port_net(ref_params)
    lf = net.backbone_local(torch.as_tensor(ia)[None, ..., None])
    port = TS.detector_ce(net, lf, torch.as_tensor(ta, dtype=torch.int64)[None])
    assert abs(float(port) - float(ref)) <= TOL_LOSS * abs(float(ref))


def test_adam_step_matches_optax(ref_params, batch):
    """One train step: optax.adam(1e-3) on the reference, torch.optim.Adam on
    the port, from the same weights and batch. Adam's first step moves a
    weight by lr * g / (|g| + 1e-8): where |g| is near 1e-8 it amplifies the
    gradients' last-bit differences (TOL_GRAD) to ~1e-4, so the weights are
    held to TOL_WEIGHTS where the reference's gradient is at least
    ADAM_FLAT (100 eps, where the step is within 1% of lr * sign(g)), and
    everywhere the port's step is held to that formula on its own gradient
    (the optimizers on one gradient: the next test)."""
    lr, eps = 1e-3, 1e-8
    opt = optax.adam(lr)
    p0 = jax.tree.map(jnp.asarray, ref_params)
    _, g_tree = _ref_grads(ref_params, batch, 1.0)
    g_r = _ref_grad_by_port_key(g_tree)
    # the body of the reference's train_step, on the gradient above
    updates, _ = opt.update(g_tree, opt.init(p0), p0)
    p1 = optax.apply_updates(p0, updates)
    net = TS.trainable_copy(_port_net(ref_params), "cpu")
    w0 = {k: v.clone() for k, v in net.state_dict().items()}
    TS.train_step(net, TS.make_optimizer(net, lr), *[torch.as_tensor(x) for x in batch],
                  HW, 1.0)
    want = convert.hfnet_params_from_reference(jax.tree.map(np.asarray, p1))
    n_flat = 0
    for k, p in net.named_parameters():
        v, gr = p.detach(), g_r[k]
        gp = torch.zeros_like(v) if p.grad is None else p.grad
        step = w0[k] - lr * gp / (gp.abs() + eps)
        # float32 rounding of w - step: a few ulps at |w| of a few units
        assert float((v - step).abs().max()) <= 5e-7, k
        big = gr.abs() >= ADAM_FLAT
        err = float((v - want[k])[big].abs().max()) if big.any() else 0.0
        assert err <= TOL_WEIGHTS, (k, err)
        n_flat += int((~big & (gr != 0)).sum())
    print(f"{n_flat} weights with 0 < |g| < {ADAM_FLAT} held to Adam's step only")


def test_adam_update_equals_optax_on_the_same_gradient():
    """The optimizer alone: the same gradients through three steps of each."""
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(1e-3)
    pj, st = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    pt = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    topt = torch.optim.Adam([pt], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        up, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, up)
        pt.grad = torch.as_tensor(g)
        topt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-7, rtol=0)


def _record(world_obj, into):
    real = world_obj.correspondences

    def spy(pose_a, pose_b, depth_a, n, rng, margin=16):
        into.append((np.asarray(pose_a[1]).tolist(), np.asarray(pose_b[1]).tolist()))
        return real(pose_a, pose_b, depth_a, n, rng, margin)
    return spy


def test_five_train_steps_match_reference(ref_params, worlds, monkeypatch):
    ref_w, port_w = worlds
    kw = dict(n_steps=5, n_pairs=96, pose_range=60, n_frames_cache=10, seed=1)
    pairs_r, pairs_p, losses_r = [], [], []
    monkeypatch.setattr(ref_w, "correspondences", _record(ref_w, pairs_r))
    monkeypatch.setattr(port_w, "correspondences", _record(port_w, pairs_p))
    real_step = JS.train_step

    def step(*a, **k):
        out = real_step(*a, **k)
        losses_r.append(float(out[2]))
        return out
    monkeypatch.setattr(JS, "train_step", step)
    _, stats_r = JS.train(ref_w, params=jax.tree.map(jnp.asarray, ref_params), **kw)
    net, stats_p = TS.train(port_w, net=_port_net(ref_params), device="cpu", **kw)
    assert pairs_p == pairs_r and len(pairs_r) == 5
    assert stats_p["steps"] == stats_r["steps"] == len(losses_r)
    np.testing.assert_allclose(stats_p["losses"], losses_r, rtol=TOL_TRAIN)
    # the returned net is frozen and ready for the extractor
    assert not any(p.requires_grad for p in net.parameters()) and not net.training


def test_port_descriptor_loss_decreases(worlds):
    """tests/test_selftrain.py:67-71 on the port alone (its seed-0 init)."""
    _, stats = TS.train(worlds[1], n_steps=25, n_pairs=96, pose_range=60, n_frames_cache=10,
                        device="cpu")
    assert stats["steps"] >= 15
    assert stats["loss_last"] < 0.6 * stats["loss_first"], stats


@pytest.mark.slow  # training and 30 CNN forwards: the reference's heavy tier
def test_port_rgbd_tracking_with_the_trained_cnn(worlds):
    """tests/test_selftrain.py's CNN-in-the-loop check on the port: train
    briefly, then the real extractor in the RGB-D SLAM loop must hold the
    sequence (never LOST, >= 90% tracked, >= 3 keyframes) with an ATE under
    0.35 x the path."""
    from hfnet_slam_torch.evaluation import ate
    from hfnet_slam_torch.models.extractor import HFExtractor
    from hfnet_slam_torch.slam.local_mapping import MapperConfig
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig
    from hfnet_slam_torch.slam.tracking import LOST, TrackerConfig

    world = worlds[1]
    cam = world.cam
    net, _ = TS.train(world, n_steps=80, n_pairs=128, pose_range=80, n_frames_cache=16,
                      device="cpu")
    ext = HFExtractor(net, HW, n_features=300, n_levels=2, pad_to=512, threshold=0.003,
                      device="cpu")
    cfg = SystemConfig(
        k_max=64, m_max=8192, n_slots=512, desc_dim=256, gdesc_dim=4096, loop_closing=False,
        baseline=0.1,
        tracker=TrackerConfig(local_mp_cap=1024, th_high=0.6, th_low=0.5, motion_window=8.0,
                              local_window=3.0, th_depth=30.0),
        mapper=MapperConfig(ba_kf_cap=16, ba_mp_cap=2048, ba_edge_cap=8192, tri_neighbors=5))
    sys_ = SLAMSystem(cam, ext, cfg, device="cpu")
    est, gtc, states = [], [], []
    n_frames = 30
    try:
        for i in range(n_frames):
            R, t = world.orbit_pose(i)
            img, dep = world.render_rgbd(R, t)
            st, Re, te = sys_.track_rgbd(img, dep, 0.05 * i)
            states.append(st)
            if Re is not None:
                est.append(-Re.T @ te)
                gtc.append(-R.T @ t)
        n_kf = int(sys_.store.kf_valid.sum())
    finally:
        sys_.shutdown()
    assert LOST not in states, states
    assert len(est) >= 0.9 * n_frames and n_kf >= 3
    err = ate.ate_rmse(np.asarray(est), np.asarray(gtc), with_scale=False)
    path = np.linalg.norm(np.diff(np.asarray(gtc), axis=0), axis=1).sum()
    assert err < 0.35 * path, f"ATE {err:.3f} over {path:.2f} m"


def test_train_logs_its_loss_every_n_steps(worlds):
    """train(log_every=1) reports each step's loss through utils/log at
    NORMAL (the reference's own log_every imports a function its log module
    lacks: ROADMAP Queue 3 (g)); at QUIET it reports nothing."""
    from hfnet_slam_torch.utils import log
    from test_torch_utils import _log_records

    records, h = _log_records(log)
    try:
        _, quiet = TS.train(worlds[1], n_steps=2, n_pairs=64, pose_range=20, n_frames_cache=4,
                            log_every=1, device="cpu")
        assert records == []
        log.set_level("normal")
        _, stats = TS.train(worlds[1], n_steps=3, n_pairs=64, pose_range=20, n_frames_cache=4,
                            log_every=1, device="cpu")
    finally:
        log.logger.removeHandler(h)
        log.set_level("quiet")
    assert stats["steps"] >= 1 and len(records) == stats["steps"]
    assert all(m.startswith("selftrain step ") for _, m in records)
    assert records[0][1].endswith(f"loss {stats['losses'][0]:.3f}")
