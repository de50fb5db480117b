"""Port parity, modules: each vps_torch module against its vps_tpu module on
the same weights and seeded numpy inputs, on the CPU, f32 (the `exact`
preset's compute).

JAX variables come from ``jax.eval_shape`` of ``init`` filled with seeded
numpy values (a full flax init of FlowNet2 alone costs minutes); the port
loads them through ``vps_torch.convert.state_dict_from_jax``, so the weight
bridge is exercised on every module. Tolerance: max |diff| <= 1e-4 of the
output's max magnitude (+1e-5), i.e. agreement to summation order through
tens of f32 layers.

This file holds the helpers; every module has a one-test file of its own
(``test_torch_port_modules_*.py``, ``test_torch_port_flownet2.py``):
pytest-xdist's loadfile scheduler queues files by their number of tests,
most first, so one-test files start after the files with several and leave
the suite's wall where it is.
"""

import numpy as np
import jax
import torch

from vps_torch.convert import state_dict_from_jax

T = torch.from_numpy


def _fill(tree, rng):
    """Seeded values for an eval_shape tree: fan-in scaled kernels, norm
    scales near 1, small biases / offsets, BN stats near (0, 1)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, rng)
            continue
        shape = tuple(v.shape)
        z = rng.standard_normal(shape, dtype=np.float32)
        if k in ("kernel", "weight"):
            fan = int(np.prod(shape[:-1]))
            out[k] = z * np.float32(1.4 / np.sqrt(fan))
        elif k == "scale":
            out[k] = 1.0 + 0.1 * z
        elif k == "var":
            out[k] = 1.0 + 0.1 * np.abs(z)
        else:  # bias, mean
            out[k] = 0.1 * z
    return out


def _bridge(jmod, prefix, port, *args, method=None, seed=0, variables=None):
    """eval_shape-init `jmod`, fill, load the same values into `port` (which
    may be built on the meta device: the values are assigned). Returns the
    flax variables. ``variables``: a module's of the same parameter tree,
    filled already (no init trace)."""
    if variables is None:
        shapes = jax.eval_shape(
            lambda: jmod.init(jax.random.PRNGKey(0), *args, method=method))
        rng = np.random.default_rng(seed)
        variables = {k: _fill(v, rng) for k, v in shapes.items()}
    sd = state_dict_from_jax({prefix: variables["params"]},
                             {prefix: variables.get("batch_stats", {})})
    port.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()},
                         strict=True, assign=True)
    return variables


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-5)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()
