"""Launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``) made inside
the program's ``train.step`` spans of the traced window, over its steps."""

from portbench import span_trace


def read(summary):
    return span_trace.per_step(summary.get("span_trace"), "train.step", "launches")
