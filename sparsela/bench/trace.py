"""Device time from a profiler trace.

``jax.profiler`` records every kernel the card runs with its start and
duration on the device's clock. ``device_time`` traces ``reps`` warm
calls of a function and reduces the trace to the busy time of the
device per call: the union of the kernel intervals on the device
plane's stream lines (overlapping kernels count once), so host dispatch
gaps between calls are excluded. That is the number to hold against a
roofline; a host-clock time per call also contains the dispatch.
"""

from __future__ import annotations

import glob
import os
import tempfile
from collections import Counter


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, device_prefix: str = "/device:GPU:0",
                 line_prefix: str = "Stream") -> dict:
    """Busy nanoseconds on one device plane of a ``.xplane.pb`` trace:
    the union of the events on lines whose name starts with
    ``line_prefix`` (the CUDA stream lines; the derived "XLA Modules" /
    "XLA Ops" lines repeat the same time), plus the kernel names by
    total duration and the plane's line names with event counts."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    intervals, kernels, lines = [], Counter(), {}
    for plane in pd.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[line.name] = len(evs)
            if not line.name.startswith(line_prefix):
                continue
            for ev in evs:
                intervals.append((int(ev.start_ns), int(ev.end_ns)))
                kernels[ev.name] += int(ev.duration_ns)
    return {"busy_ns": _union_ns(intervals), "kernels": kernels,
            "lines": lines}


def device_time(fn, *args, reps: int = 20, logdir: str | None = None
                ) -> dict:
    """Trace ``reps`` warm calls of ``fn(*args)`` and return the device
    busy seconds per call (``busy_s``), the top kernels and the trace's
    line structure. ``fn`` is compiled and warmed before the window."""
    import jax

    jax.block_until_ready(fn(*args))
    logdir = logdir or tempfile.mkdtemp(prefix="trace_")
    with jax.profiler.trace(logdir):
        out = None
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    red = reduce_trace(paths[-1])
    return {"busy_s": red["busy_ns"] / reps / 1e9,
            "kernels": red["kernels"].most_common(8),
            "lines": red["lines"], "path": paths[-1]}
