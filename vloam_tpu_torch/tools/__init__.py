"""Measurement tools of the port (run as ``python -m vloam_tpu_torch.tools.<name>``)."""
