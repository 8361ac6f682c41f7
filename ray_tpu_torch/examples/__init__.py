"""Quickstarts of the port: ``python -m ray_tpu_torch.examples.<name>``."""
