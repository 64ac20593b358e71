"""Measurement tools of the port, each run as ``python -m
meshrecon_torch.tools.<name>``."""
