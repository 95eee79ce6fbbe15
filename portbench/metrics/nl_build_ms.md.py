"""Milliseconds of a device neighbour-list build
(`DeviceNeighborList.build`), CUDA events around each build of the
window, the mean over the builds."""


def read(run):
    return run.values.get("nl_build_ms")
