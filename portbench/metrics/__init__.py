"""One reader a metric, `<metric name>.py` with `read(run) -> float or
None`; None leaves the metric out of the result's line."""
