"""Sequence driver and CLI (``python -m vloam_tpu_torch.runtime``)."""
