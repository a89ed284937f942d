"""syncs_frame: median blocking device-to-host synchronizations a frame
that the program's own code issues (its `syncs` counter: torch's sync
debug mode, charged to the program's spans; the harness's fences are not
counted)."""
from ..harness import program_trace


def read(run):
    return program_trace.median_count(run, "syncs")
