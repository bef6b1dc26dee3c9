"""Seconds from the process' start to the window's: imports, the kernel
build where there is one, the data, the engine and the warm-up."""


def read(run):
    return run["setup_s"]
