"""Milliseconds of a train step's loss and loss backward (the parameter
gradient through the forces), CUDA events at the predictions' end and
the optimizer's start, the mean over every step of the window."""


def read(run):
    return run.values.get("loss_ms")
