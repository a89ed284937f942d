"""hfnet075_roofline: share (%) of HF-Net's forward roofline reached by its
kernels in the traced window, the network at the configuration's width
(0.75 in the published HF-Net). hfnet_roofline's method: per call, the
bound is the larger of its FLOPs at 67 TFLOP/s (float32) and its least
bytes at 3.35 TB/s, both counted from the input's shape at the feed's
`depth_multiplier` (reference/hfnet_dm.forward_cost); the time is the device
time of the kernels launched inside the calls' spans, placed by the span
markers. None where the feed states no width: the 1.0 counts would put a
narrower network's share too high."""
from ..harness.stats import H100_BYTES_PER_S, H100_FP32_FLOPS
from ..reference.hfnet_dm import forward_cost


def read(run):
    m = getattr(run.feed, "depth_multiplier", None)
    if run.trace is None or m is None:
        return None
    ivs = run.trace.intervals(run.spans.boundaries)
    if ivs is None:
        return None
    calls = [iv for iv in ivs if iv[0] == "hfnet"]
    outer = [c for c in calls if not any(o is not c and o[2] <= c[2] and c[3] <= o[3]
                                         for o in calls)]
    bound = 0.0
    for _, info, _, _ in outer:
        if info[0] in ("global", "local"):
            c = forward_cost(info[1], info[2], info[0] == "global", m)
            bound += max(c["flops"] / H100_FP32_FLOPS, c["min_bytes"] / H100_BYTES_PER_S)
    ns = run.trace.kernel_ns_in([(a, b) for _, _, a, b in outer])
    if ns <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ns * 1e-9)
