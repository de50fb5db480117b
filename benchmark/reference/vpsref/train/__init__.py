"""Training loop of the port (port of vps_tpu/train: optim, step, runner,
eval_hook, and dist: data-parallel training across processes)."""
