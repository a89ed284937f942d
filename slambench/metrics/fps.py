"""fps: frames finished inside the window over the window's seconds."""


def read(run):
    return len(run.frame_s) / run.window_s
