"""The port's HF-Net pyramid extractor (hfnet_slam_torch/models/extractor.py)
against the reference's (hfnet_slam_tpu/models/extractor.py) on the CPU,
mirrors of tests/test_hfnet.py's extractor checks, and the extractor behind
SLAMSystem.track_monocular.

Both packages get the reference's He-initialized parameters
(hfnet.init_params(PRNGKey(0))) as numpy and the same seeded image.
Tolerances: the share of slots with the same mask and xy (within 1e-3 px)
at least 99% (measured here: 100% at both configurations), the octave
exactly on those slots, descriptors and scores on shared valid slots and
the global descriptor within 1e-4 (float32 convs summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hfnet_slam_tpu.models import hfnet as JH  # noqa: E402
from hfnet_slam_tpu.models.extractor import HFExtractor as JExtractor  # noqa: E402
from hfnet_slam_torch import convert  # noqa: E402
from hfnet_slam_torch.models import hfnet as TH  # noqa: E402
from hfnet_slam_torch.models.extractor import HFExtractor  # noqa: E402

MIN_SHARED = 0.99
TOL_XY = 1e-3
TOL_DESC = 1e-4

# tests/test_hfnet.py's extractor, and a 2-level one on an odd global tail
CONFIGS = {
    "test_hfnet": ((96, 128), dict(n_features=200, threshold=1e-5, pad_to=256)),
    "two_levels": ((96, 152), dict(n_features=200, n_levels=2, pad_to=256)),
}


@pytest.fixture(scope="module")
def ref_params():
    return JH.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def net(ref_params):
    return TH.HFNet.from_state(
        convert.hfnet_params_from_reference(jax.tree.map(np.asarray, ref_params)), "cpu")


def _image(hw, seed=4):
    return np.random.default_rng(seed).uniform(0, 255, hw).astype(np.float32)


@pytest.fixture(scope="module")
def feats(net):
    hw, kw = CONFIGS["test_hfnet"]
    ext = HFExtractor(net, hw, device="cpu", **kw)
    return ext, ext(_image(hw))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_extractor_matches_reference(ref_params, net, name):
    hw, kw = CONFIGS[name]
    img = _image(hw)
    ref = [np.asarray(x) for x in JExtractor(ref_params, hw, **kw)(jnp.asarray(img))]
    got = [x.numpy() for x in HFExtractor(net, hw, device="cpu", **kw)(img)]
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == r.dtype
    same = (got[4] == ref[4]) & (np.abs(got[0] - ref[0]).max(1) <= TOL_XY)
    assert same.mean() >= MIN_SHARED, f"{name}: {same.mean():.4f} of slots agree"
    np.testing.assert_array_equal(got[2][same], ref[2][same])
    both = same & ref[4]
    assert both.sum() > 100
    assert np.abs(got[3] - ref[3])[both].max() <= TOL_DESC
    assert np.abs(got[1] - ref[1])[both].max() <= TOL_DESC
    assert np.abs(got[5] - ref[5]).max() <= TOL_DESC


def test_level_sizes_budgets_and_pad_check(net):
    ext = HFExtractor(net, (480, 752), device="cpu")
    assert ext.level_hw == [(480, 752), (400, 624), (328, 520), (272, 432)]
    assert sum(ext.budgets) == 1000 and ext.budgets[0] > ext.budgets[1] > ext.budgets[2]
    assert HFExtractor(net, (100, 130), device="cpu").image_hw == (96, 128)  # crop to 8
    with pytest.raises(ValueError, match="pad_to"):
        HFExtractor(net, (96, 128), n_features=300, pad_to=256, device="cpu")


# -- mirrors of tests/test_hfnet.py::TestExtractor ---------------------------

def test_shapes_and_masks(feats):
    _, f = feats
    assert f.xy.shape == (256, 2) and f.desc.shape == (256, 256)
    assert f.global_desc.shape == (4096,)
    assert (f.xy.dtype, f.score.dtype, f.octave.dtype, f.desc.dtype, f.mask.dtype,
            f.global_desc.dtype) == (torch.float32, torch.float32, torch.int32,
                                     torch.float32, torch.bool, torch.float32)
    assert bool(f.mask.any())
    xy = f.xy[f.mask].numpy()
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 128 * 1.001).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 96 * 1.001).all()


def test_descriptors_normalized(feats):
    _, f = feats
    np.testing.assert_allclose(torch.linalg.norm(f.desc[f.mask], dim=-1).numpy(), 1.0,
                               atol=1e-4)
    assert abs(float(torch.linalg.norm(f.global_desc)) - 1.0) < 1e-4


def test_nms_separation_level0(feats):
    _, f = feats
    xy = f.xy[f.mask & (f.octave == 0)].numpy()
    d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
    d[np.arange(len(xy)), np.arange(len(xy))] = 1e9
    assert len(xy) > 1 and d.min() > 4.0


def test_deterministic_and_input_forms(feats):
    """Two calls agree bit for bit, and a uint8 image, an (H,W,1) array and
    a tensor give the same features as the float (H,W) array."""
    ext, f = feats
    img = _image((96, 128))
    f2 = ext(img)
    for a, b in zip(f, f2):
        assert torch.equal(a, b)
    q = np.round(img).astype(np.uint8)
    fq = ext(q)
    for other in (ext(q[..., None]), ext(torch.from_numpy(q)), ext(q.astype(np.float32))):
        for a, b in zip(fq, other):
            assert torch.equal(a, b)


def test_bfloat16_runs_the_network_in_bf16(net, feats):
    """dtype=bfloat16 casts a copy of the weights (the caller's net stays
    float32); outputs stay float32, and most level-0 keypoints coincide with
    the float32 run's. A float32 extractor on the net's own device uses the
    net as it is."""
    _, f32 = feats
    hw, kw = CONFIGS["test_hfnet"]
    assert HFExtractor(net, hw, device="cpu", **kw).net is net
    ext = HFExtractor(net, hw, dtype=torch.bfloat16, device="cpu", **kw)
    assert next(ext.net.parameters()).dtype == torch.bfloat16
    assert next(net.parameters()).dtype == torch.float32
    f = ext(_image(hw))
    assert (f.xy.dtype, f.desc.dtype, f.global_desc.dtype) == (torch.float32,) * 3
    assert torch.isfinite(f.desc).all() and bool(f.mask.any())
    a = {tuple(p) for p in f.xy[f.mask & (f.octave == 0)].round().int().tolist()}
    b = {tuple(p) for p in f32.xy[f32.mask & (f32.octave == 0)].round().int().tolist()}
    assert len(a & b) >= 0.5 * len(b)


# -- behind the facade ---------------------------------------------------------

def test_track_monocular_through_the_extractor(net):
    """SLAMSystem(cam, HFExtractor) takes images: track_monocular extracts
    and tracks, and the features reach the tracker on the system's device."""
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.slam.system import SLAMSystem, SystemConfig

    hw, kw = CONFIGS["test_hfnet"]
    ext = HFExtractor(net, hw, device="cpu", **kw)
    cam = cameras.pinhole(100.0, 100.0, 64.0, 48.0, 128, 96, device="cpu")
    sys_ = SLAMSystem(cam, ext, SystemConfig(n_slots=256, k_max=16, m_max=2048,
                                             desc_dim=256, gdesc_dim=4096,
                                             loop_closing=False), device="cpu")
    canvas = np.random.default_rng(9).uniform(0, 255, (96, 160)).astype(np.float32)
    states = []
    for i in range(3):
        st, _, _ = sys_.track_monocular(canvas[:, 4 * i:4 * i + 128], 0.05 * i)
        states.append(int(st))
    tr = sys_.tracker
    frame = tr.last_frame or tr.init_ref
    assert tr.frame_id == 3 and frame is not None
    assert frame.feats.desc.shape == (256, 256) and frame.feats.desc.device.type == "cpu"


def test_euroc_hfnet_system_builds_and_tracks_on_the_cpu():
    """The EuRoC cam0 system at bench.py's headline extractor config."""
    from hfnet_slam_torch.scenes import euroc_hfnet_system

    sys_ = euroc_hfnet_system(device="cpu")
    ext = sys_.extractor
    assert (ext.image_hw, ext.pad_to, ext.n_levels, ext.threshold) == ((480, 752), 1024, 4, 0.01)
    assert (sys_.cfg.n_slots, sys_.cfg.desc_dim, sys_.cfg.gdesc_dim) == (1024, 256, 4096)
    assert (sys_.cam.width, sys_.cam.height) == (752, 480)
    img = np.random.default_rng(0).integers(0, 256, (480, 752), dtype=np.uint8)
    f = ext(img)
    assert f.xy.shape == (1024, 2) and int(f.mask.sum()) > 500
    sys_.track_monocular(img, 0.0)
    assert sys_.tracker.frame_id == 1 and sys_.tracker.init_ref is not None
