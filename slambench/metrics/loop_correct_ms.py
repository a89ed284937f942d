"""loop_correct_ms: median host ms of the program's `loop.correct` span, one
a correction (LoopCloser._correct_loop: the window's Sim3 propagation, loop
fusion, the essential graph and, in the synchronous pipeline, the global BA
inline), over the counted frames."""
from ..harness import program_trace


def read(run):
    return program_trace.span_median_ms(run, "loop.correct")
