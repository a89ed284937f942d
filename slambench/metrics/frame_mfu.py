"""frame_mfu: share (%) of the card's float32 peak that the window's model
arithmetic would take: HF-Net's forward FLOPs of every frame finished in
the window (counted from the shapes of the configuration's pyramid) and
the matcher's 2 NA NB D a row_top2 launch (counted by the program's launch
counters), over the window's seconds, at 67 TFLOP/s."""
from ..harness.stats import H100_FP32_FLOPS


def read(run):
    flops = run.feed.frame_flops() * len(run.frame_s)
    flops += sum(2.0 * a * b * d * n for (a, b, d), n in run.launches_window.items())
    if flops <= 0:
        return None
    return 100.0 * flops / run.window_s / H100_FP32_FLOPS
