"""Command-line entry points: ``python -m sgc_tpu_torch.cli.<name>``."""
