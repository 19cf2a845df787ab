"""Reduce a torch.profiler trace of the window to what the metrics read.

Device records are the profiler's CUDA rows: kernels (graph-replayed ones
too), memory copies and memsets.  Busy time is the union of their
intervals, so kernels that overlap count once.  Each idle gap between
busy intervals is named by the host activity the CPU side of the trace
shows at its middle: the outermost CPU operation running then, or
"host between ops" (the interpreter) when none is.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def records(prof):
    """(device records, CPU records) of a stopped ``torch.profiler.profile``
    as (start us, end us, name), read from the profiler's raw results: the
    per-event objects that ``prof.events()`` would build take minutes for
    a window of millions of launches."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name()))
        elif kind == DeviceType.CPU:
            name = e.name()
            if not name.startswith("PyTorch Profiler"):
                cpu.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, name))
    return dev, cpu


def summarize(dev, cpu, conv5_marker: str = "conv5_kernel") -> dict:
    """A summary of a trace's device and CPU records (``records``): kernel
    count and summed kernel seconds, busy seconds (the union), the conv5
    kernel's durations in time order, the top device operations by time
    and the idle gaps by host activity (seconds summed by name)."""
    dev.sort()
    kernels = [d for d in dev if _is_kernel(d[2])]
    by_name = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += e - s
    conv5 = [(e - s) * 1e-6 for s, e, n in kernels if conv5_marker in n]

    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s

    # outermost CPU operations: those not inside an earlier one's span
    cpu.sort()
    tops, reach = [], float("-inf")
    for s, e, n in cpu:
        if s >= reach:
            tops.append((s, e, n))
        reach = max(reach, e)
    starts = [t[0] for t in tops]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = tops[i][2] if i >= 0 and tops[i][1] >= mid else "host between ops"
        idle[name] += (g1 - g0) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "kernels": len(kernels),
        "kernel_s": sum(e - s for s, e, _ in kernels) * 1e-6,
        "busy_s": busy * 1e-6,
        "conv5_s": conv5,
        "device_ops": top({k: v * 1e-6 for k, v in by_name.items()}),
        "idle_gaps": top(idle),
    }
