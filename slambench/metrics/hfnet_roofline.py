"""hfnet_roofline: share (%) of HF-Net's forward roofline reached by its
kernels in the traced window. Per call, the bound is the larger of its
FLOPs at 67 TFLOP/s (float32: the port runs HF-Net in full float32) and
its least bytes at 3.35 TB/s, both counted from the input's shape
(reference/hfnet.forward_cost); the time is the device time of the
kernels launched inside the calls' spans, placed by the span markers."""
from ..harness.stats import H100_BYTES_PER_S, H100_FP32_FLOPS
from ..reference.hfnet import forward_cost


def read(run):
    if run.trace is None:
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
            c = forward_cost(info[1], info[2], info[0] == "global")
            bound += max(c["flops"] / H100_FP32_FLOPS, c["min_bytes"] / H100_BYTES_PER_S)
    ns = run.trace.kernel_ns_in([(a, b) for _, _, a, b in outer])
    if ns <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ns * 1e-9)
