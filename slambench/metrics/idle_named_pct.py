"""idle_named_pct: share (%) of the card's idle time in all traced slices
during which the host's innermost open program span, on the frames'
thread, lay below a `frame` span: how much of the idle card the program's
spans name. Gaps come from the device trace, spans through the recorder's
shared clock, with no marker kernels."""
from ..harness import program_trace


def read(run):
    return program_trace.idle_named_pct(run)
