"""step_host_ms: median host ms a frame of the program's `track.step` span:
the enqueue of slam/fused.track_step (motion search, pose LM, local search,
pose LM), what a CUDA graph of the step would remove."""
from ..harness import program_trace


def read(run):
    return program_trace.median_ms(run, ("track.step",))
