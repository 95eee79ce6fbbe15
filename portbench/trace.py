"""The traced run's device timeline, reduced to aggregates.

`Profiled` runs a block under `torch.profiler` and keeps no trace file:
it reduces the events to the union of the device's busy intervals, the
device time of each kernel name and, where it records the host too, the
idle gaps by what the host was doing, then drops them. A traced run
profiles its whole window with the card's activity alone, which leaves
the host's pace as it is untraced, and then a short slice after the
window with the host's ops and ranges as well, for the idle gaps.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW = "portbench.window"
RANGE_PREFIX = "portbench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Profiled:
    """Context manager: the profiled block, with the host's ops and
    ranges where `host`. After it, `busy_s`, `kernel_seconds` (name ->
    [launches, seconds]), `device_ops` and, where `host`, `window_s` (the
    block's range) and `idle_gaps` are set. The caller that profiles the
    card alone sets `window_s` from its own clock."""

    def __init__(self, host: bool = False):
        self.host = host
        self.window_s = 0.0
        self.idle_gaps = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._torch = torch
        activities = [ProfilerActivity.CUDA]
        if self.host:
            activities.append(ProfilerActivity.CPU)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._range = record_function(WINDOW) if self.host else None
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    def _reduce(self, events) -> None:
        device, host, ranges = [], [], []
        window = None
        for e in events:
            kind = _kind(e)
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if kind in DEVICE_ACTIVITIES:
                device.append((start, end, e.name()))
            elif kind == "user_annotation" and e.name().startswith(
                    RANGE_PREFIX):
                if e.name() == WINDOW:
                    window = (start, end)
                else:
                    ranges.append((start, end, e.name()[len(RANGE_PREFIX):]))
            elif kind == "cpu_op":
                host.append((start, end, e.name()))
        # a range of the host mirrored on the device's timeline is no work
        names = {n for *_, n in host}
        device = [d for d in device if d[2] not in names
                  and not d[2].startswith(RANGE_PREFIX)]
        if self.host:
            if window is None:
                raise RuntimeError("the profiler recorded no window range")
            lo, hi = window
            self.window_s = (hi - lo) * 1e-9
        elif device:
            # the card alone: every operation profiled is the block's
            lo = min(s for s, _, _ in device)
            hi = max(e for _, e, _ in device)
        else:
            lo = hi = 0
        device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device
                        if e > lo and s < hi)
        per_kernel = defaultdict(lambda: [0, 0.0])
        for s, e, n in device:
            per_kernel[n][0] += 1
            per_kernel[n][1] += (e - s) * 1e-9
        self.kernel_seconds = dict(per_kernel)
        busy, gaps, cursor = 0, [], lo
        for s, e, _ in device:
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if hi > cursor:
            gaps.append((cursor, hi))
        self.busy_s = busy * 1e-9
        self.device_ops = sorted(
            ([n, t] for n, (_, t) in per_kernel.items()),
            key=lambda x: -x[1])[:TOP]
        if self.host:
            self.idle_gaps = _attribute(gaps, sorted(ranges), sorted(host))

    def kernels(self, patterns) -> tuple:
        """(launches, device seconds) of the kernels whose names match any
        of the regular expressions `patterns`."""
        regex = [re.compile(p) for p in patterns]
        n, t = 0, 0.0
        for name, (count, seconds) in self.kernel_seconds.items():
            if any(r.search(name) for r in regex):
                n += count
                t += seconds
        return n, t


def _kind(event) -> str:
    """The event's kineto activity type, where this torch names it, else
    told from its device and whether it is a user's range."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    from torch.autograd import DeviceType
    annotation = getattr(event, "is_user_annotation", lambda: False)()
    if event.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation or event.name().startswith(
        RANGE_PREFIX) else "cpu_op"


def _innermost(intervals, starts, t):
    """The latest-starting interval of a sorted list that contains t."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - 512, -1), -1):
        s, e, name = intervals[j]
        if e >= t:
            return name
    return None


def _attribute(gaps, ranges, host):
    """Idle seconds summed by what the host was doing at each gap's
    middle: the harness's innermost range and the host op inside it."""
    r_starts = [r[0] for r in ranges]
    h_starts = [h[0] for h in host]
    by = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        where = _innermost(ranges, r_starts, mid) or "outside any range"
        op = _innermost(host, h_starts, mid) or "no host op"
        by[f"{where} / {op}"] += (e - s) * 1e-9
    return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:TOP]


def host_range(name: str):
    """A host range of the harness, named for the idle-gap attribution."""
    from torch.profiler import record_function
    return record_function(RANGE_PREFIX + name)


def idle_gaps_of(block) -> list:
    """Run `block()` under a profile of the host and the card -> its idle
    gaps by what the host was doing."""
    with Profiled(host=True) as prof:
        block()
    return prof.idle_gaps


def share_of_bound(run, kernels: dict):
    """Sum of the frozen bounds of the launches found over their device
    time, in %: `kernels` maps a key of `run.launch_bound_s` (the bound
    of one launch) to the regular expressions of its kernel names. None
    where no such kernel ran in the traced window."""
    if run.trace is None:
        return None
    bound = seconds = 0.0
    for key, patterns in kernels.items():
        n, t = run.trace.kernels(patterns)
        if n and key in run.launch_bound_s:
            bound += n * run.launch_bound_s[key]
            seconds += t
    return 100.0 * bound / seconds if seconds > 0 else None


def kernel_shares(run) -> dict:
    """Each kernel's share of its roofline, in %, by the name
    `<key>_kernel` of each key of `run.launch_bound_s` that ran."""
    out = {}
    for key in run.launch_bound_s:
        share = share_of_bound(run, {key: [r"\b" + key + r"_kernel\b"]})
        if share is not None:
            out[f"{key}_kernel"] = share
    return out
