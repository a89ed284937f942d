"""h2d_kb_frame: median KiB a frame copied host to device through the
program's upload helper (hfnet_slam_torch/device.upload: the image, the
depth map, the map mirror's and the keyframe bank's rows, the tracker's and
mapper's inputs), the program's `h2d_bytes` counter over the frame's spans."""
from ..harness import program_trace


def read(run):
    return program_trace.median_count(run, "h2d_bytes", 1.0 / 1024)
