"""Kernel device time launched inside the program's ``step.forward`` spans
of the traced window, a step, in ms (``span_trace.attribute``)."""

from portbench import span_trace


def read(summary):
    return span_trace.per_step(summary.get("span_trace"), "step.forward", "device_ms")
