"""Training on one device (port of ray_tpu/train/step.py's single-device
path)."""
