"""extract_host_ms: median host ms a frame of the program's own `extract`
span (HFExtractor.__call__: the image upload, HF-Net's launches on every
pyramid level and the keypoint post-processing), unfenced: beside
extract_ms, which fences the card at both ends, it splits launch time from
device time."""
from ..harness import program_trace


def read(run):
    return program_trace.median_ms(run, ("extract",))
