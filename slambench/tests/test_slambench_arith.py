"""The benchmark's arithmetic against hand counts: percentiles, rates,
roofline and MFU shares, span self times, the trace's busy time, span
intervals and idle gaps, and HF-Net's FLOP count at a small shape."""
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slambench.harness import stats
from slambench.harness.trace import Trace
from slambench.metrics import (device_idle_pct, fps, frame_mfu, frame_ms_p50, frame_ms_p95,
                               track_ms)
from slambench.reference import ba as RB
from slambench.reference import hfnet as RH


def test_percentiles_and_rate():
    run = types.SimpleNamespace(frame_s=[i / 1000 for i in range(1, 101)], window_s=20.0)
    assert frame_ms_p50.read(run) == pytest.approx(50.5)
    assert frame_ms_p95.read(run) == pytest.approx(95.05)
    assert fps.read(run) == pytest.approx(5.0)
    assert stats.percentile([], 50) is None


def test_roofline_share_takes_the_larger_bound():
    # 67e9 flops take 1 ms at 67 TFLOP/s; 3.35e9 bytes take 1 ms at 3.35 TB/s
    assert stats.roofline_pct(67e9, 0, 4e-3, 67e12) == pytest.approx(25.0)
    assert stats.roofline_pct(0, 6.7e9, 4e-3, 67e12) == pytest.approx(50.0)
    assert stats.roofline_pct(1, 1, 0, 67e12) is None


def test_frame_mfu_by_hand():
    feed = types.SimpleNamespace(frame_flops=lambda: 20e9)
    run = types.SimpleNamespace(feed=feed, frame_s=[0.25] * 40, window_s=10.0,
                                launches_window={(1024, 1024, 256): 10})
    flops = 40 * 20e9 + 10 * 2.0 * 1024 * 1024 * 256
    assert frame_mfu.read(run) == pytest.approx(100 * flops / 10.0 / 67e12)


def test_self_times_and_track_ms():
    parents = [(0.0, 1.0), (2.0, 2.5)]
    kids = [(0.2, 0.5), (0.6, 0.7), (2.1, 2.2)]
    assert stats.self_times(parents, kids) == pytest.approx([0.6, 0.4])
    spans = types.SimpleNamespace(spans={"track": [(0.0, 1.0, None), (2.0, 2.5, None)],
                                         "mapping": [(0.2, 0.5, None), (0.6, 0.7, None),
                                                     (2.1, 2.2, None)]})
    assert track_ms.read(types.SimpleNamespace(spans=spans)) == pytest.approx(500.0)


def _slice(start, secs, busy_ns, markers, b):
    return {"start": start, "secs": secs, "busy_ns": busy_ns, "markers": markers, "b": b}


def test_trace_busy_intervals_and_gaps():
    tr = Trace()
    tr.kernels = [("a", 0, 10_000), ("b", 5_000, 20_000), ("c", 50_000, 60_000)]
    tr.slices = [_slice(0.0, 1e-6 * 100, 30_000, [0, 25_000, 40_000, 70_000], (0, 4))]
    assert tr.busy_s() == pytest.approx(30e-6)
    run = types.SimpleNamespace(trace=tr)
    assert device_idle_pct.read(run) == pytest.approx(70.0)
    b = [("track", "B", None), ("mapping", "B", None), ("mapping", "E", None),
         ("track", "E", None)]
    assert tr.intervals(b) == [("mapping", None, 25_000, 40_000), ("track", None, 0, 70_000)]
    gaps = tr.idle_gaps(b)
    assert gaps[0][0] == "track" and gaps[0][1] == pytest.approx(30e-6)
    assert tr.kernel_ns_in([(0, 24_000)]) == 25_000
    # a second slice: the stretch between the slices is no idle gap, and a
    # slice whose markers do not match its boundaries is left out
    tr.kernels.append(("d", 900_000, 905_000))
    tr.cuts.add(900_000)
    b2 = b + [("track", "B", None), ("track", "E", None)]
    tr.slices.append(_slice(0.5, 1e-6 * 50, 5_000, [899_000, 906_000], (4, 6)))
    assert tr.window_s == pytest.approx(150e-6)
    assert tr.idle_gaps(b2)[0][1] == pytest.approx(30e-6)
    assert [round(x[2], 6) for x in tr.slice_idle()] == [70.0, 90.0]
    assert tr.intervals(b2)[-1] == ("track", None, 899_000, 906_000)
    tr.slices[1]["markers"] = [906_000]
    assert tr.intervals(b2) == tr.intervals(b)
    tr.slices[0]["markers"] = [0, 25_000, 40_000]
    assert tr.intervals(b2) is None


def test_forward_flops_match_a_count_of_the_convolutions():
    """forward_cost's FLOPs equal 2 Ho Wo Cout k k Cin / groups summed over
    every conv that the reference forward really runs, plus NetVLAD's
    contraction and the projection, at 64x96."""
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=g) * 0.01 for k, (s, _) in RH.param_shapes().items()}
    count = [0.0]
    real = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = real(x, w, b, stride, padding, dilation, groups)
        count[0] += 2.0 * y.shape[2] * y.shape[3] * w.shape[0] * w.shape[1] * w.shape[2] \
            * w.shape[3]
        return y

    h, w = 64, 96
    img = torch.rand(1, 1, h, w) * 255
    F.conv2d = counting
    try:
        lf = RH.backbone_local(p, img)
        RH.dense_scores(p, lf)
        RH.descriptor_map(p, lf)
        local = count[0]
        RH.global_desc(p, lf)
    finally:
        F.conv2d = real
    assert RH.forward_cost(h, w, False)["flops"] == pytest.approx(local)
    hh, ww = h // 32, w // 32
    extra = 2.0 * hh * ww * 64 * 320 + 2.0 * 64 * 320 * 4096
    assert RH.forward_cost(h, w, True)["flops"] == pytest.approx(count[0] + extra)


def test_level_shapes_and_budgets():
    assert RH.level_shapes((480, 640), 4, 1.2) == [(480, 640), (400, 528), (328, 440),
                                                   (272, 368)]
    b = RH.level_budgets(675, 1.2, 4)
    assert sum(b) == 675 and b == sorted(b, reverse=True)
    assert np.isclose(b[0] / b[1], 1.2, atol=0.02)


def _ba_problem():
    """Three RGB-D keyframes (the first fixed) seeing 40 points, with the
    free poses and the points pushed off the truth."""
    g = torch.Generator().manual_seed(3)
    cam = torch.tensor([100.0, 100.0, 64.0, 48.0], dtype=torch.float64)
    P = torch.rand(40, 3, generator=g, dtype=torch.float64) * torch.tensor([4.0, 3.0, 2.0]) \
        + torch.tensor([-2.0, -1.5, 4.0])
    R = torch.eye(3, dtype=torch.float64).repeat(3, 1, 1)
    t = torch.tensor([[0.0, 0, 0], [-0.3, 0, 0], [-0.6, 0.1, 0]], dtype=torch.float64)
    kf = torch.arange(3).repeat_interleave(40)
    pt = torch.arange(40).repeat(3)
    pc = (R[kf] @ P[pt][..., None])[..., 0] + t[kf]
    uv = torch.stack([100 * pc[:, 0] / pc[:, 2] + 64, 100 * pc[:, 1] / pc[:, 2] + 48], -1)
    uv = uv + 0.3 * torch.randn(uv.shape, generator=g, dtype=torch.float64)
    ones = torch.ones(len(kf), dtype=torch.float64)
    prob = {"poses_R": R, "poses_t": t + torch.tensor([[0.0, 0, 0], [0.02, -0.01, 0.01],
                                                        [0.01, 0.02, -0.01]], dtype=torch.float64),
            "fixed": torch.tensor([True, False, False]),
            "points": P + 0.02 * torch.randn(P.shape, generator=g, dtype=torch.float64),
            "kf_idx": kf, "pt_idx": pt, "uv": uv, "inv_sigma2": ones,
            "valid": torch.ones(len(kf), dtype=torch.bool), "z_meas": pc[:, 2],
            "wz": ones * 2.0}
    return cam, prob


def test_ba_excess_reads_one_for_the_input_and_none_for_a_solve():
    cam, prob = _ba_problem()
    x, (c_in, c_out, c_ref) = RB.excess(cam, prob, prob["poses_R"], prob["poses_t"],
                                        prob["points"])
    assert x == pytest.approx(1.0) and c_in > 3 * c_ref
    e = RB.edges(prob["kf_idx"], prob["pt_idx"], prob["uv"], prob["inv_sigma2"],
                 prob["valid"], prob["z_meas"], prob["wz"])
    (R, t, P), keep = RB.bundle_adjust(cam, e, prob["poses_R"], prob["poses_t"],
                                       prob["points"], prob["fixed"])
    assert bool(keep.all())
    assert torch.equal(R[0], prob["poses_R"][0]) and torch.equal(t[0], prob["poses_t"][0])
    x, _ = RB.excess(cam, prob, R, t, P)
    assert x < 1e-9
    # halfway from the input to the solution leaves a share in between
    x, _ = RB.excess(cam, prob, R, (t + prob["poses_t"]) / 2, (P + prob["points"]) / 2)
    assert 0.05 < x < 0.9
    # a problem already at its optimum reads near 0 for its own state
    done = dict(prob, poses_R=R, poses_t=t, points=P)
    x, (c_in, _, c_ref) = RB.excess(cam, done, R, t, P)
    assert x < 1e-3 and c_in - c_ref < 1e-3 * c_in
