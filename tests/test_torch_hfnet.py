"""Parity of the port's HF-Net (hfnet_slam_torch/models/hfnet.py) and its
extraction post-processing (ops/extract.py) with the JAX reference, on the
CPU, and the weight plumbing between the two packages.

The same numpy inputs and parameters go through both packages:
  * forward: the reference's He-initialized parameters
    (hfnet.init_params(PRNGKey(0))) carried across as numpy, at 64x64 and
    at 96x152 (an odd input to the stride-2 convs of the global tail:
    19 -> 10 -> 5), with tests/test_activation_parity.py's tolerances: dense
    scores, descriptor map and global descriptor max abs err < 1e-4, local
    endpoint rel err < 1e-4 (float32 convs summed in another order);
  * the float64 NumPy golden of tests/test_activation_parity.py on the raw
    synthetic TF checkpoint, with its two harness-discrimination checks;
  * the extract functions on maps with plateaus of equal scores, a zero
    tail wider than k, and border and out-of-map keypoints: indices and
    masks exactly, floats within 1e-6;
  * the pyramid resize against jax.image.resize at the four EuRoC level
    sizes, within 5e-3 on [0,255] (separable filters summed in another
    order).
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hfnet_slam_tpu.models import hfnet as JH  # noqa: E402
from hfnet_slam_tpu.ops import extract as JX  # noqa: E402
from hfnet_slam_torch import convert  # noqa: E402
from hfnet_slam_torch.models import extractor as TE  # noqa: E402
from hfnet_slam_torch.models import hfnet as TH  # noqa: E402
from hfnet_slam_torch.ops import extract as TX  # noqa: E402
from tests.test_activation_parity import np_forward  # noqa: E402
from tests.test_convert import _synthetic_ckpt, cvt  # noqa: E402

TOL_OUT = 1e-4   # dense scores, descriptor map, global descriptor (max abs)
TOL_LOCAL = 1e-4  # local endpoint (relative to its max)
TOL_POST = 1e-6   # extract functions (float32, same operations)
TOL_RESIZE = 5e-3  # resize on [0,255]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_net(tree):
    return TH.HFNet.from_state(convert.hfnet_params_from_reference(_np_tree(tree)), "cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def ref_params():
    return JH.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def net(ref_params):
    return _port_net(ref_params)


def _run_port(net, image, with_global=True):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in net(_t(image), with_global=with_global).items()}


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 64), (96, 152)])
def test_forward_matches_reference(ref_params, net, hw):
    image = np.random.default_rng(1).uniform(0, 255, (1, *hw, 1)).astype(np.float32)
    ref = JH.forward(ref_params, jnp.asarray(image), with_global=True)
    got = _run_port(net, image)
    for k in ("scores_dense", "desc_map", "global_desc"):
        assert got[k].shape == ref[k].shape, k
        err = np.abs(got[k] - np.asarray(ref[k])).max()
        assert err < TOL_OUT, f"{k} max abs err {err:.2e}"
    gold = np.asarray(JH.backbone_local(ref_params, jnp.asarray(image)))
    with torch.inference_mode():
        local = net.backbone_local(_t(image)).numpy()
    err = np.abs(local - gold).max() / max(np.abs(gold).max(), 1e-6)
    assert err < TOL_LOCAL, f"local endpoint rel err {err:.2e}"


def test_forward_valid_mask_matches_reference(ref_params, net):
    """A padded canvas: the global head pools only the cells the mask,
    sampled every 32 px and cropped to the global map, keeps."""
    hw = (96, 152)
    image = np.random.default_rng(8).uniform(0, 255, (1, *hw, 1)).astype(np.float32)
    mask = np.ones((1, *hw), bool)
    mask[:, :, 100:] = False
    ref = JH.forward(ref_params, jnp.asarray(image), with_global=True,
                     valid_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got = net(_t(image), with_global=True, valid_mask=_t(mask))["global_desc"].numpy()
    assert np.abs(got - np.asarray(ref["global_desc"])).max() < TOL_OUT
    unmasked = _run_port(net, image)["global_desc"]
    assert np.abs(got - unmasked).max() > 10 * TOL_OUT  # the mask changed the pooling


def test_same_padding_is_asymmetric_on_even_inputs():
    """XLA's SAME rule at the level-0 tail of a 752-wide image: 94 -> 47
    pads (0, 1), 47 -> 24 pads (1, 1); a 1x1 or stride-1 3x3 pads (1, 1)."""
    assert TH.same_pad(94, 3, 2) == (0, 1)
    assert TH.same_pad(47, 3, 2) == (1, 1)
    assert TH.same_pad(94, 3, 1) == (1, 1)
    assert TH.same_pad(94, 1, 1) == (0, 0)
    x = np.random.default_rng(2).standard_normal((1, 10, 7, 3)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((3, 3, 3, 4)).astype(np.float32)
    ref = np.asarray(JH._conv(jnp.asarray(x), jnp.asarray(w), jnp.zeros(4), stride=2))
    conv = TH.Conv(3, 4, 3, 2, generator=torch.Generator())
    conv.weight.copy_(_t(w.transpose(3, 2, 0, 1)))
    conv.bias.zero_()
    got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_detector_depth_to_space_order(net):
    """Channel c = dy*8 + dx of cell (h, w) lands at pixel (8h+dy, 8w+dx),
    TF's depth_to_space (DCR) order: one-hot logits make it visible."""
    g = torch.Generator().manual_seed(0)
    head = net
    h, w = 2, 3
    logits = torch.full((1, 65, h, w), -30.0)
    hot = {(0, 0): 0, (0, 1): 9, (1, 2): 63, (1, 0): 64}  # 64 = dustbin
    for (r, c), ch in hot.items():
        logits[0, ch, r, c] = 30.0
    prob = torch.softmax(logits, dim=1)[:, :-1]
    scores = torch.nn.functional.pixel_shuffle(prob, TH.DETECTOR_GRID)[0, 0]
    ref = np.asarray(jax.nn.softmax(jnp.asarray(logits.permute(0, 2, 3, 1).numpy()), -1)[..., :-1])
    ref = ref.reshape(1, h, w, 8, 8).transpose(0, 1, 3, 2, 4).reshape(8 * h, 8 * w)
    np.testing.assert_array_equal(scores.numpy(), ref)
    assert float(scores[0, 0]) > 0.99 and float(scores[1, 9]) > 0.99
    assert float(scores[15, 23]) > 0.99 and float(scores[8:16, 0:8].max()) < 1e-20
    # and the module's own head computes exactly this from its logits
    feat = torch.randn(1, h, w, 128, generator=g)
    with torch.inference_mode():
        s, _ = head.local_head(feat)
        lg = head.det1(TH.relu6(head.det0(feat.permute(0, 3, 1, 2))))
        want = torch.nn.functional.pixel_shuffle(torch.softmax(lg, 1)[:, :-1], 8)[:, 0]
    assert torch.equal(s, want)


def test_fold_bn_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, 16), rng.standard_normal(16), rng.standard_normal(16),
          rng.uniform(0.2, 2.0, 16)]
    bn = [b.astype(np.float32) for b in bn]
    wr, br = JH.fold_bn(jnp.asarray(w), *map(jnp.asarray, bn))
    wt, bt = TH.fold_bn(_t(w.transpose(3, 2, 0, 1)), *map(_t, bn))
    np.testing.assert_allclose(wt.numpy().transpose(2, 3, 1, 0), np.asarray(wr), rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(br), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the float64 golden on the raw synthetic checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    ckpt = _synthetic_ckpt(np.random.default_rng(42))
    image = np.random.default_rng(3).uniform(0, 255, (1, 64, 64, 1)).astype(np.float32)
    return ckpt, cvt.convert(ckpt), image, np_forward(ckpt, image)


def test_float64_golden(golden):
    _, params, image, gold = golden
    net = _port_net(params)
    got = _run_port(net, image)
    for k in ("scores_dense", "desc_map", "global_desc"):
        err = np.abs(got[k] - gold[k]).max()
        assert err < TOL_OUT, f"{k} err {err:.2e}"
    with torch.inference_mode():
        local = net.backbone_local(_t(image)).numpy()
    err = np.abs(local - gold["local_feat"]).max() / max(np.abs(gold["local_feat"]).max(), 1e-6)
    assert err < TOL_LOCAL, f"local endpoint rel err {err:.2e}"


def test_golden_catches_transposed_kernel(golden):
    """The harness discriminates: desc0's kernel with its spatial axes
    swapped must blow the descriptor parity."""
    _, params, image, gold = golden
    net = _port_net(params)
    with torch.no_grad():
        net.desc0.weight.copy_(net.desc0.weight.transpose(2, 3).clone())
    got = _run_port(net, image, with_global=False)
    assert np.abs(got["desc_map"] - gold["desc_map"]).max() > 1e-2


def test_golden_catches_bn_fold_error(golden, monkeypatch):
    """A whole tree folded with slim's eps 1e-3 replaced by 1e-5 must break
    parity beyond the 1e-4 tolerance."""
    ckpt, _, image, gold = golden
    monkeypatch.setattr(cvt, "BN_EPS", 1e-5)
    got = _run_port(_port_net(cvt.convert(ckpt)), image)
    err = max(np.abs(got["desc_map"] - gold["desc_map"]).max(),
              np.abs(got["global_desc"] - gold["global_desc"]).max())
    assert err > TOL_OUT


# ---------------------------------------------------------------------------
# weights across packages
# ---------------------------------------------------------------------------

def test_load_params_reads_the_reference_file(tmp_path, ref_params, net):
    JH.save_params(tmp_path / "ref.npz", ref_params)
    loaded = TH.load_params(tmp_path / "ref.npz", device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # and the port's file loads back into the reference
    TH.save_params(tmp_path / "port.npz", loaded)
    back = JH.load_params(tmp_path / "port.npz")
    for (k, a), (_, b) in zip(JH._flatten(ref_params), JH._flatten(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)


def test_load_params_rejects_a_wrong_shape(tmp_path, ref_params):
    flat = {k: np.asarray(v) for k, v in JH._flatten(ref_params)}
    flat["blocks/3/expand/w"] = flat["blocks/3/expand/w"][..., :-1]
    np.savez(tmp_path / "bad.npz", **flat)
    with pytest.raises(ValueError, match="blocks/3/expand/w"):
        TH.load_params(tmp_path / "bad.npz", device="cpu")
    del flat["blocks/3/expand/w"]
    with pytest.raises(KeyError):
        TH.state_from_flat(flat)


def test_params_from_reference_round_trip(ref_params, net):
    """tree -> port state: dense convs OIHW, depthwise (mid,1,3,3), the
    projection transposed; and back to the reference's flat layout."""
    tree = _np_tree(ref_params)
    state = convert.hfnet_params_from_reference(tree)
    assert state["conv0.weight"].shape == (32, 1, 3, 3)
    assert state["blocks.1.depthwise.weight"].shape == (96, 1, 3, 3)
    assert state["blocks.1.expand.weight"].shape == (96, 16, 1, 1)
    assert state["proj.weight"].shape == (TH.GLOBAL_DIM, TH.N_CLUSTERS * TH.GLOBAL_FEAT)
    np.testing.assert_array_equal(state["proj.weight"].numpy(), tree["proj"]["w"].T)
    np.testing.assert_array_equal(state["blocks.1.depthwise.weight"].numpy()[:, 0],
                                  tree["blocks"][1]["depthwise"]["w"][:, :, 0].transpose(2, 0, 1))
    flat = TH.flat_from_state(state)
    for k, v in JH._flatten(tree):
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert set(flat) == {k for k, _ in JH._flatten(tree)}


def test_he_init_follows_the_reference_distributions():
    """HFNet(generator) draws He-normal convs (std sqrt(2 / fan_in)), zero
    biases, clusters N(0, 0.1^2): the reference's init_params."""
    net = TH.HFNet(torch.Generator().manual_seed(0))
    w = net.blocks[1].expand.weight  # fan_in 16
    assert abs(float(w.std()) - np.sqrt(2 / 16)) < 0.05 * np.sqrt(2 / 16)
    dw = net.blocks[1].depthwise.weight  # fan_in 9
    assert abs(float(dw.std()) - np.sqrt(2 / 9)) < 0.1 * np.sqrt(2 / 9)
    assert abs(float(net.vlad_clusters.std()) - 0.1) < 0.01
    assert float(net.proj.bias.abs().max()) == 0.0
    again = TH.HFNet(torch.Generator().manual_seed(0))
    assert torch.equal(again.proj.weight, net.proj.weight)


# ---------------------------------------------------------------------------
# extract functions on identical numpy maps
# ---------------------------------------------------------------------------

def _plateau_map(seed, H=40, W=56):
    """A score map of a few quantized levels: plateaus of equal scores, a
    mostly-zero background and peaks on the border."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.uniform(0, 1, (H, W)), 1).astype(np.float32)
    s[rng.uniform(0, 1, (H, W)) < 0.75] = 0.0
    s[10:14, 20:24] = 0.7  # a flat plateau
    s[0, 5] = s[H - 1, W - 1] = 0.95  # border peaks
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_simple_nms_matches_reference(seed):
    s = np.stack([_plateau_map(seed), _plateau_map(seed + 10)])
    ref = np.asarray(JX.simple_nms(jnp.asarray(s), radius=4))
    got = TX.simple_nms(_t(s), radius=4).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 5


@pytest.mark.parametrize("k", [8, 150])
def test_select_keypoints_ties_and_zero_tail(k):
    """After NMS few peaks survive: with k = 150 the tail is zero-score ties
    (wider than k), whose slots must take the same (lowest) flat indices."""
    s = np.asarray(JX.simple_nms(jnp.asarray(_plateau_map(3)[None]), radius=4))[0]
    assert (s > 0).sum() < 150 < (s == 0).sum()
    vm = np.ones_like(s, bool)
    vm[:, :6] = False
    for valid in (None, vm):
        ref = JX.select_keypoints(jnp.asarray(s), None if valid is None else jnp.asarray(valid),
                                  0.15, k)
        got = TX.select_keypoints(_t(s), None if valid is None else _t(valid), 0.15, k)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # equal scores on a plateau: exact ties in the first slots too
    flat = np.zeros((6, 9), np.float32)
    flat[1:4, 2:7] = 0.5
    ref = JX.select_keypoints(jnp.asarray(flat), None, 0.1, 12)
    got = TX.select_keypoints(_t(flat), None, 0.1, 12)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_refine_subpixel_matches_reference():
    rng = np.random.default_rng(5)
    H, W = 32, 40
    ys, xs = np.mgrid[0:H, 0:W]
    s = np.exp(-((xs - 17.3) ** 2 + (ys - 11.6) ** 2) / 4.5) + rng.uniform(0, 0.05, (H, W))
    s = s.astype(np.float32)
    s[20:25, 5:10] = 0.3  # flat: zero denominators
    xy = np.concatenate([rng.integers(0, [W, H], (40, 2)),
                         [[0, 5], [W - 1, 7], [9, 0], [12, H - 1], [0, 0], [W - 1, H - 1],
                          [7, 22], [17, 12]]]).astype(np.float32)
    ref = np.asarray(JX.refine_subpixel(jnp.asarray(s), jnp.asarray(xy)))
    got = TX.refine_subpixel(_t(s), _t(xy)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_POST, rtol=0)
    np.testing.assert_array_equal(got[40:46], xy[40:46])  # border keypoints stay


def test_sample_descriptors_matches_reference():
    """Inside, on the edge and outside the map (zero padding), with the
    align-corners coordinates."""
    rng = np.random.default_rng(6)
    h, w, C, H, W = 6, 8, 16, 48, 64
    dm = rng.standard_normal((h, w, C)).astype(np.float32)
    xy = np.concatenate([rng.uniform([-6, -6], [W + 6, H + 6], (60, 2)),
                         [[0, 0], [W - 1, H - 1], [3 * (W - 1) / (w - 1), 2 * (H - 1) / (h - 1)],
                          [W - 0.5, 10.0], [-0.7, 20.0]]]).astype(np.float32)
    ref = np.asarray(JX.sample_descriptors(jnp.asarray(dm), jnp.asarray(xy), (H, W)))
    got = TX.sample_descriptors(_t(dm), _t(xy), (H, W)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_POST, rtol=0)
    # a permuted (non-contiguous) map, as the network hands it over
    dmp = _t(dm.transpose(2, 0, 1).copy()).permute(1, 2, 0)
    np.testing.assert_allclose(TX.sample_descriptors(dmp, _t(xy), (H, W)).numpy(), ref,
                               atol=TOL_POST, rtol=0)


@pytest.mark.parametrize("args", [(1000, 1.2, 4), (200, 1.2, 4), (300, 1.2, 2), (5, 2.0, 8)])
def test_level_budgets_match_reference(args):
    assert TX.level_budgets(*args) == JX.level_budgets(*args)


@pytest.mark.parametrize("hw", [(480, 752), (400, 624), (328, 520), (272, 432)])
def test_resize_matches_jax_image_resize(hw):
    image = np.random.default_rng(7).uniform(0, 255, (480, 752)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(image)[..., None], (*hw, 1), method="bilinear"))
    got = TE.resize(_t(image), hw).numpy()
    err = np.abs(got - ref[..., 0]).max()
    assert err <= TOL_RESIZE, f"resize to {hw}: max abs err {err:.2e}"
