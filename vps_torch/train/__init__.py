"""Training loop of the port (port of vps_tpu/train: optim, step, runner)."""
