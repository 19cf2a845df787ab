"""``step_mfu_pct`` in the MNI cell: the untraced window's step products
(``flops.step_flops`` at the MNI grid, each step's batch width) over its
wall time and the H100's dense TF32 peak, in %."""

from portbench.metrics.step_mfu_pct import read  # noqa: F401
