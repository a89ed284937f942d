"""device_wait_ms: median host ms a frame of the program's readback spans,
`frame.readback` (the depth lookup at the keypoints and its copy back) and
`track.readback` (the fused step's outputs), where the frame path waits
for the card."""
from ..harness import program_trace


def read(run):
    return program_trace.median_ms(run, ("frame.readback", "track.readback"))
