"""Host duration of the program's ``step.adam`` spans, a step, in ms, in
the spans window: spans on and no profiler, so the host's time is its own."""

from portbench import span_trace


def read(summary):
    window = (summary.get("spans") or {}).get("window")
    return span_trace.per_step(window, "step.adam", "host_ms")
