"""Synchronising calls (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, the synchronous ``cudaMemcpy``) made inside the
program's ``train.epoch`` spans of the traced window, over its steps: the
eager gather's index copy and each epoch's read of its losses."""

from portbench import span_trace


def read(summary):
    return span_trace.per_step(summary.get("span_trace"), "train.epoch", "syncs")
