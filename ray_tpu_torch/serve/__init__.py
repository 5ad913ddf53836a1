"""Serving layer of the port (counterpart of ray_tpu/serve)."""
