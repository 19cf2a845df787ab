"""Lay the program's spans over a torch.profiler trace of the window.

It imports nothing of the program.  Its inputs are plain tuples on one
clock, Unix-epoch nanoseconds (the program's span recorder takes its
timestamps on torch.profiler's clock):

- spans: ``(name, start_ns, end_ns, id, parent, step, attrs)``, as the
  program records them (``attrs`` a dict or None);
- device records: ``(start_ns, end_ns, name, correlation, linked)``, the
  profiler's CUDA rows (kernels, graph-replayed ones too, copies and
  memsets); ``correlation`` is the id of the CUDA runtime call that
  launched it, ``linked`` that of the CPU operation around the call;
- CPU records: ``(start_ns, end_ns, name, correlation)``, the profiler's
  CPU rows: CUDA runtime and driver calls (``cudaLaunchKernel`` and so on)
  and operations.

Each device record goes to the innermost span that encloses its launch:
the runtime call of the same correlation id (a graph replay's kernels that
of ``cudaGraphLaunch``, inside ``step.replay``), else the CPU operation of
its linked id.  The spans are opened on one thread; the launch may be on
another (autograd's device thread launches the backward), so the span is
found by time.  Launch calls and synchronising calls are counted by the
innermost span around each, idle gaps of the device (between the union
of its records) named by the innermost span at their middle.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

TOP = 10
NO_SPAN = "no span"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def is_launch(name: str) -> bool:
    """A call that puts work on a stream (``cudaLaunchKernel*`` and
    ``cuLaunchKernel*`` in all their forms)."""
    return name.startswith(LAUNCHES[:2]) or name in LAUNCHES[2:]


def is_sync(name: str) -> bool:
    """A call that waits for the device (the synchronous ``cudaMemcpy``,
    not ``cudaMemcpyAsync``)."""
    return name in SYNCS


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def kineto_records(prof, drop=()):
    """(device records, CPU records) of a stopped ``torch.profiler.profile``,
    read from its raw results (module docstring).  Records named in `drop`
    are left out: the program's spans, whose ``record_function`` the
    profiler keeps as a CPU row and, over the device work launched inside
    it, as a CUDA row too."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if e.name() in drop:
            continue
        if kind == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif kind == DeviceType.CPU:
            cpu.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    return dev, cpu


def _innermost(spans):
    """(times, ids): from ``times[k]`` on, until the next time, span
    ``ids[k]`` is the innermost open one (None outside every span).  Spans
    of one thread nest, so a stack sweep gives it."""
    segs, stack = [], []
    for s in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= s[1]:
            top = stack.pop()
            segs.append((top[2], stack[-1][3] if stack else None))
        stack.append(s)
        segs.append((s[1], s[3]))
    while stack:
        top = stack.pop()
        segs.append((top[2], stack[-1][3] if stack else None))
    return [t for t, _ in segs], [i for _, i in segs]


def _finder(spans):
    times, ids = _innermost(spans)

    def at(t):
        k = bisect.bisect_right(times, t) - 1
        return ids[k] if k >= 0 else None
    return at


def gaps(dev):
    """The idle intervals between the union of the device records."""
    out, cur_e = [], None
    for s, e, *_ in sorted(dev):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def attribute(spans, dev=(), cpu=()) -> dict:
    """Per span name, summed over its spans (ms and counts; "self" leaves
    out what lies in child spans): ``count``, ``host_ms``, ``host_self_ms``,
    ``device_ms`` / ``device_self_ms`` (kernel device time launched inside),
    ``kernels`` / ``kernels_self``, ``launches`` / ``launches_self`` and
    ``syncs`` / ``syncs_self``; besides, ``steps`` (``train.step`` spans),
    ``kernel_s`` and ``kernel_s_in_spans`` (all kernels, and those launched
    inside some span), ``unlinked_kernels`` (no launch call found) and
    ``idle_by_span`` (the device's idle seconds by the innermost span at
    each gap's middle, the top ``TOP``).  Without device records it gives
    the host's numbers alone."""
    spans = [tuple(s) for s in spans]
    by_id = {s[3]: s for s in spans}
    at = _finder(spans)
    runtime, ops = {}, {}
    fields = ("device_ns", "kernels", "launches", "syncs")
    own = {i: dict.fromkeys(fields, 0) for i in by_id}
    for s, _, name, corr in cpu:
        if _RUNTIME.match(name):
            runtime[corr] = s
            i = at(s)
            if i is not None:
                own[i]["launches"] += is_launch(name)
                own[i]["syncs"] += is_sync(name)
        else:
            ops[corr] = s
    kernel_ns = inside_ns = 0
    unlinked = 0
    for s, e, name, corr, linked in dev:
        if not is_kernel(name):
            continue
        kernel_ns += e - s
        t = runtime.get(corr, ops.get(linked) if linked else None)
        if t is None:
            unlinked += 1
            continue
        i = at(t)
        if i is not None:
            inside_ns += e - s
            own[i]["device_ns"] += e - s
            own[i]["kernels"] += 1

    # inclusive totals: each span's own, then its children's, deepest first
    depth = {}
    for i in by_id:
        d, p = 0, by_id[i][4]
        while p in by_id:
            d, p = d + 1, by_id[p][4]
        depth[i] = d
    incl = {i: dict(own[i]) for i in by_id}
    child_ns = defaultdict(int)
    for i in sorted(by_id, key=depth.get, reverse=True):
        p = by_id[i][4]
        if p in by_id:
            for f in fields:
                incl[p][f] += incl[i][f]
            child_ns[p] += by_id[i][2] - by_id[i][1]

    names = {}
    for i, s in by_id.items():
        n = names.setdefault(s[0], defaultdict(float))
        n["count"] += 1
        n["host_ms"] += (s[2] - s[1]) * 1e-6
        n["host_self_ms"] += (s[2] - s[1] - child_ns[i]) * 1e-6
        n["device_ms"] += incl[i]["device_ns"] * 1e-6
        n["device_self_ms"] += own[i]["device_ns"] * 1e-6
        for f in fields[1:]:
            n[f] += incl[i][f]
            n[f + "_self"] += own[i][f]

    idle = defaultdict(float)
    for g0, g1 in gaps(dev):
        i = at(0.5 * (g0 + g1))
        idle[by_id[i][0] if i is not None else NO_SPAN] += (g1 - g0) * 1e-9
    return {
        "by_name": {k: dict(v) for k, v in sorted(names.items())},
        "steps": sum(s[0] == "train.step" for s in spans),
        "kernel_s": kernel_ns * 1e-9,
        "kernel_s_in_spans": inside_ns * 1e-9,
        "unlinked_kernels": unlinked,
        "idle_by_span": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def per_step(at, name: str, key: str):
    """``at["by_name"][name][key]`` over the steps; None where there is
    nothing to read (no such reading, span or step)."""
    if not at or not at["steps"] or name not in at["by_name"]:
        return None
    return at["by_name"][name][key] / at["steps"]


def new_width_s(spans):
    """Seconds of the steps marked ``first_at_width`` less the ``ops.build``
    spans inside them (a kernel library's first-run compile); None when no
    step is marked."""
    spans = [tuple(s) for s in spans]
    firsts = [s for s in spans if s[0] == "train.step" and (s[6] or {}).get("first_at_width")]
    if not firsts:
        return None
    builds = [s for s in spans if s[0] == "ops.build"]
    total = 0
    for f in firsts:
        total += f[2] - f[1] - sum(b[2] - b[1] for b in builds
                                   if f[1] <= b[1] and b[2] <= f[2])
    return total * 1e-9
