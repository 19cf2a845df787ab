"""Seconds of set-up's first step at each batch width (the program's
``train.step`` spans marked ``first_at_width``: cuDNN's algorithm search
for the width and, under ``epoch_scan``, its capture), less the
``ops.build`` spans inside them (conv5's first-run compile)."""

from portbench import span_trace


def read(summary):
    setup = (summary.get("spans") or {}).get("setup")
    return span_trace.new_width_s(setup) if setup else None
