"""Validation tools of the port (``python -m vaegam_tpu_torch.tools.control_experiment``)."""
