"""The untraced window's step products (``flops.step_flops`` at each step's
batch width) over its wall time and the H100's dense TF32 peak, in %.  The
untraced window, since the profiler slows a host-bound step."""

from collections import Counter

from portbench import flops


def read(summary):
    win = summary["window"]
    if not win["steps"]:
        return None
    total = sum(n * flops.step_flops(summary["cfg"], w)
                for w, n in Counter(win["widths"]).items())
    return 100.0 * total / win["window_s"] / flops.PEAK_FLOPS
