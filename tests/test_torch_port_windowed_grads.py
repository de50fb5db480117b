"""Port parity, the windowed deformable conv's gradients: autograd through
``vps_torch.ops.deform_conv2d_windowed`` on the CPU against ``jax.grad`` of
vps_tpu's, with the inputs and helpers of ``test_torch_port_ops.py``.

It is the file's only test on purpose: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so a one-test file starts
after the files with several, off the path of the suite's longest file.
"""

import numpy as np
import jax.numpy as jnp

from vps_tpu.ops.deform_conv import (
    deform_conv2d_windowed as jax_deform_conv2d_windowed,
)

from test_torch_port_ops import T, _hwio, _windowed_inputs
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import ops


def test_deform_conv2d_windowed_grads():
    """Gradients of x, offset and weight against jax.grad (whose backward
    is the VJP of _windowed_ref), offsets partly clamped, rtol/atol 1e-4."""
    import jax

    rng = np.random.RandomState(14)
    x, off, weight = _windowed_inputs(rng, (1, 6, 6, 2), 3, 2.5)
    g = rng.randn(1, 6, 6, 3).astype(np.float32)
    jgrads = jax.jit(jax.grad(
        lambda a, o, w_: jnp.sum(jax_deform_conv2d_windowed(a, o, w_, 1, 2)
                                 * jnp.asarray(g)), argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(_hwio(weight)))
    xs, offs, ws = (T(a.copy()).requires_grad_() for a in (x, off, weight))
    (ops.deform_conv2d_windowed(xs, offs, ws, 1, 2) * T(g)).sum().backward()
    for got, want in ((xs.grad, jgrads[0]), (offs.grad, jgrads[1]),
                      (ws.grad.permute(2, 3, 1, 0), jgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
