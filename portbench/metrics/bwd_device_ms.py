"""Kernel device time launched inside the program's ``step.backward`` spans
of the traced window, a step, in ms: autograd's device thread launches it,
so it is found by the launch call's time."""

from portbench import span_trace


def read(summary):
    return span_trace.per_step(summary.get("span_trace"), "step.backward", "device_ms")
