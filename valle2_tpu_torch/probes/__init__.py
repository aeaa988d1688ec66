"""Measurement probes of the port: small programs that time one piece of the
card against its bound (``python -m valle2_tpu_torch.probes.<name>``)."""
