"""Kernel device time launched inside the program's ``step.adam`` spans of
the traced window (the eager Adam, ``Trainer._apply_gradients``), a step,
in ms."""

from portbench import span_trace


def read(summary):
    return span_trace.per_step(summary.get("span_trace"), "step.adam", "device_ms")
