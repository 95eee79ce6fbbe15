"""Host milliseconds a step spent inside the program's enqueue of the MD
chunks (`VelocityVerlet._chunk`, before the chunk end's read-back),
summed over the window over its steps. Where the card paces the run
(md_grap_ni108k), the host fills the launch queue and then waits in a
launch for room, so this reads the device's time a step, not the cost
of the enqueue; it reads the enqueue where the host paces the run."""


def read(run):
    return run.values.get("host_ms_per_step")
