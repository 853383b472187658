"""Self-checking end-to-end demos of the port's public API (counterparts
of the reference's ``examples/``), run as ``python -m
repro_torch.examples.<name> [--device cpu]``."""
