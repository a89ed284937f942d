"""setup_s: process start until the window opens (imports, the kernels'
build or load, weights, traffic, warm-up)."""


def read(run):
    return run.setup_s
