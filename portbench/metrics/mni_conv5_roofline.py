"""``conv5_roofline`` in the MNI cell: conv5's share of its roofline at the
MNI widths, (32, 16, 20, 25, 20) and the epoch's tail (2, 16, 20, 25, 20),
in % (``flops.conv5_bound_s`` is shape-generic)."""

from portbench.metrics.conv5_roofline import read  # noqa: F401
