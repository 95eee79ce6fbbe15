"""Seconds from the process's start to the window's: imports, loading or
building the kernels, the model, the data and the warm-up."""


def read(run):
    return run.values.get("setup_s")
