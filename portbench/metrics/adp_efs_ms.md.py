"""Milliseconds of one analytic energy-and-forces pass of the EAM family
(`nn/eam/fast_efs.py`, the integrator's `_fast_fn`), CUDA events around
each pass of the window, the mean over the passes: a step's force
evaluation and each chunk's first and last."""


def read(run):
    return run.values.get("adp_efs_ms")
