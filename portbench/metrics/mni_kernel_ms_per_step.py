"""``kernel_ms_per_step`` in the MNI cell: summed device time of the traced
window's kernel records over its train steps, in ms."""

from portbench.metrics.kernel_ms_per_step import read  # noqa: F401
