"""Command-line entry points of the port (``python -m vaegam_tpu_torch.cli.train``)."""
