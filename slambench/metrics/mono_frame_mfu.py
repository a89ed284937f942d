"""mono_frame_mfu: share (%) of the card's float32 peak that the window's
model arithmetic would take, frame_mfu's definition with the network at the
configuration's width: HF-Net's forward FLOPs of every frame finished in the
window (reference/hfnet_dm.frame_cost over the configuration's pyramid at
the feed's `depth_multiplier`; an episode's initialization frames lie
outside the harness's frames and are not counted) and the matcher's
2 NA NB D a row_top2 launch (the program's launch counters), over the
window's seconds, at 67 TFLOP/s. None where the feed states no width."""
from ..harness.stats import H100_FP32_FLOPS
from ..reference.hfnet_dm import frame_cost


def read(run):
    m = getattr(run.feed, "depth_multiplier", None)
    if m is None:
        return None
    flops = frame_cost(run.feed.image_hw, run.feed.ref_extractor, m)["flops"] * len(run.frame_s)
    flops += sum(2.0 * a * b * d * n for (a, b, d), n in run.launches_window.items())
    if flops <= 0:
        return None
    return 100.0 * flops / run.window_s / H100_FP32_FLOPS
