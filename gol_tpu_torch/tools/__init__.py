"""Measurement tools of the port (``python -m gol_tpu_torch.tools.<name>``)."""
