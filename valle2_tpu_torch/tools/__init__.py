"""Command-line tools of the port (``python -m valle2_tpu_torch.tools.<name>``)."""
