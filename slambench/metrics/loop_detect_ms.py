"""loop_detect_ms: median host ms of the program's `loop.detect` span, one a
keyframe (LoopCloser.process_keyframe's detection: retrieval, the candidate's
mutual brute force through row_top2, Sim3 RANSAC and OptimizeSim3, the
guided projection gate, the consistency check), over the counted frames."""
from ..harness import program_trace


def read(run):
    return program_trace.span_median_ms(run, "loop.detect")
