"""Measurement tools of the port, run as ``python -m mecat_tpu_torch.tools.<name>``."""
