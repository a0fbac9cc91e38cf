"""Runnable examples of the port (``python -m sgc_tpu_torch.examples.<name>``)."""
