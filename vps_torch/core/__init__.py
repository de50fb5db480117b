"""Training-target construction (port of vps_tpu/core: assigner, sampler,
targets), static shapes with validity masks as in the JAX package."""
