"""Relocalization of the port against the JAX reference (port on the CPU):
PnP RANSAC with the reference's own Gumbel picks, the blackout recovery of
tests/test_reloc.py at 512 slots on both packages, and the widened-projection
retry of TestRelocEscalation.

Tolerances: PnP inlier masks exactly, R and t within 1e-4; the blackout
runs must both relocalize into their one map, with relocalization counts
within +-1 (the RANSAC samples come from different generators)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (BLACKOUT, SMALL, T, browse_pose, browse_spec, build, cams,  # noqa: E402
                           gumbel_picks, reloc_spec)
from hfnet_slam_tpu import lie as JL  # noqa: E402


def _pnp_scene(n_out=40, N=200, seed=3):
    rng = np.random.default_rng(seed)
    R_gt = np.asarray(JL.so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
    t_gt = np.array([0.4, -0.3, 0.8], np.float32)
    pts = rng.uniform(-4, 4, (N, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    pts_w = ((pts - t_gt) @ R_gt).astype(np.float32)
    uv = np.array(cams()[0].project(jnp.asarray(pts)))
    uv[:n_out] += rng.uniform(30, 90, (n_out, 2))
    return R_gt, t_gt, pts_w, uv.astype(np.float32), n_out


@pytest.mark.parametrize("case", ["outliers", "valid_mask"])
def test_pnp_ransac_matches_reference(case):
    from hfnet_slam_tpu.optim import pnp as JP
    from hfnet_slam_torch.optim import pnp as TP

    R_gt, t_gt, pts_w, uv, n_out = _pnp_scene(n_out=40 if case == "outliers" else 0)
    N = len(pts_w)
    valid = np.ones(N, bool)
    if case == "valid_mask":
        valid[N // 2:] = False
    key, n_hyps = ([5, 9], 256) if case == "outliers" else ([1, 1], 128)
    cj, ct = cams()
    rj = JP.pnp_ransac(cj.kind, cj.params, jnp.asarray(pts_w), jnp.asarray(uv), jnp.ones(N),
                       jnp.asarray(valid), jnp.asarray(key, jnp.uint32), n_hyps=n_hyps)
    picks = gumbel_picks(key, valid, n_hyps, 6)
    rt = TP.pnp_ransac(ct.kind, ct.params, T(pts_w), T(uv), torch.ones(N), T(valid),
                       T(picks, torch.int64))
    np.testing.assert_array_equal(rt["inliers"].numpy(), np.asarray(rj["inliers"]))
    assert int(rt["n_inliers"]) == int(rj["n_inliers"])
    np.testing.assert_allclose(rt["R"].numpy(), np.asarray(rj["R"]), atol=1e-4)
    np.testing.assert_allclose(rt["t"].numpy(), np.asarray(rj["t"]), atol=1e-4)
    if case == "outliers":
        assert np.linalg.norm(rt["R"].numpy() - R_gt) < 0.05
        assert rt["inliers"].numpy()[:n_out].sum() <= 2
    else:
        assert not rt["inliers"].numpy()[N // 2:].any()


def test_draw_picks_are_distinct_valid_indices():
    from hfnet_slam_torch.optim import pnp as TP

    valid = torch.zeros(50, dtype=torch.bool)
    valid[torch.arange(0, 50, 3)] = True
    picks = TP.draw_picks(valid, 64, 6, torch.Generator().manual_seed(0))
    assert picks.shape == (64, 6)
    assert bool(valid[picks].all())
    assert all(len(set(row.tolist())) == 6 for row in picks)
    again = TP.draw_picks(valid, 64, 6, torch.Generator().manual_seed(0))
    assert torch.equal(picks, again)


def _empty_feats(pkg, n=512, d=64, g=64):
    if pkg == "tpu":
        from hfnet_slam_tpu.models.extractor import Features
        z = jnp
    else:
        from hfnet_slam_torch.models.extractor import Features
        z = torch
    return Features(xy=z.zeros((n, 2)), score=z.zeros(n), octave=z.zeros(n, dtype=z.int32),
                    desc=z.zeros((n, d)), mask=z.zeros(n, dtype=bool), global_desc=z.zeros(g))


def _blackout_run(pkg):
    """Track the 90-frame browse scene with frames 55-61 featureless.
    Returns (states seen, n_relocalizations, n_maps)."""
    sys_, ext = build(pkg, device="cpu", size=SMALL, spec=reloc_spec)
    states = []
    for i in range(90):
        feats = _empty_feats(pkg) if i in BLACKOUT else ext(*browse_pose(i))
        st, _, _ = sys_.track_features(feats, 0.05 * i)
        states.append(int(st))
    return states, sys_.tracker.n_relocalizations, sys_.atlas.n_maps()


def test_blackout_recovery_matches_reference():
    from hfnet_slam_torch.slam.tracking import OK, RECENTLY_LOST

    out = {pkg: _blackout_run(pkg) for pkg in ("tpu", "torch")}
    for states, n_reloc, n_maps in out.values():
        lost_at = states.index(RECENTLY_LOST)
        assert OK in states[lost_at:], "no relocalization after the blackout"
        assert n_reloc >= 1 and n_maps == 1
    assert abs(out["torch"][1] - out["tpu"][1]) <= 1, out


def _escalation_spec(size):
    """tests/test_reloc.py TestRelocEscalation's scene."""
    sp = browse_spec(size)
    sp["world"].update(seed=11, n_landmarks=1400)
    sp["ext"].update(desc_noise=0.02, seed=3)
    sp["tracker"]["local_mp_cap"] = 2048
    return sp


def test_widened_projection_retry(monkeypatch):
    from hfnet_slam_torch.slam.tracking import Frame

    sys_, ext = build("torch", device="cpu", size=SMALL, spec=_escalation_spec)
    for i in range(60):
        sys_.track_features(ext(*browse_pose(i)), 0.05 * i)
    feats = ext(*browse_pose(30))
    # degrade 93% of the descriptors to distance ~0.66 from the truth: past
    # the brute-force gate (0.6), inside TH_HIGH (0.75)
    rng = np.random.default_rng(0)
    desc = feats.desc.numpy().copy()
    sel = np.nonzero(feats.mask.numpy())[0]
    corrupt = rng.choice(sel, int(0.93 * len(sel)), replace=False)
    d = desc[corrupt]
    r = rng.normal(size=d.shape).astype(np.float32)
    r -= (r * d).sum(1, keepdims=True) * d
    r /= np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-9)
    a = 0.78
    desc[corrupt] = a * d + np.sqrt(1.0 - a * a) * r
    degraded = feats._replace(desc=torch.from_numpy(desc))

    tr = sys_.tracker
    monkeypatch.setattr(tr, "_reloc_escalate", lambda frame, c, n_in: n_in)
    assert not tr._relocalize(Frame(feats=degraded, timestamp=99.0)), \
        "degradation too weak: single-pass relocalization already succeeds"
    monkeypatch.undo()
    f2 = Frame(feats=degraded, timestamp=99.0)
    assert tr._relocalize(f2), "the escalation pass failed to recover"
    assert int((f2.obs >= 0).sum()) >= tr.cfg.min_reloc_inliers
    f_clean = Frame(feats=feats, timestamp=99.0)
    assert tr._relocalize(f_clean)
    assert np.linalg.norm(f2.t - f_clean.t) < 0.1
    assert np.linalg.norm(f2.R - f_clean.R) < 0.05
