"""Share of its roofline of the analytic ADP pass in the MD window, in
%: the frozen bound of one pass (`work/adp.py`, from the mean sizes of
the window's lists) over the mean device time of a pass
(`adp_efs_ms.md`'s events). The pass is many kernels; this is the
share of the whole pass."""


def read(run):
    bound, measured = (run.values.get("adp_efs_bound_ms"),
                       run.values.get("adp_efs_ms"))
    if not bound or not measured:
        return None
    return 100.0 * bound / measured
