"""Tools of the port: the correctness oracle (``control_experiment``) and the
JAX package's study tools, each ``python -m vaegam_tpu_torch.tools.NAME``.
The package's main path imports none of them."""
