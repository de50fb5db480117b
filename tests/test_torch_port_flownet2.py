"""Port parity, FlowNet2: the port's FlowNet2 against vps_tpu's on the same
weights and seeded numpy images, on the CPU, f32, with the helpers and the
tolerance of ``test_torch_port_modules.py`` (max |diff| <= 1e-4 of the
output's max magnitude, + 1e-5).

It is the file's only test on purpose: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so a one-test file starts
after the files with several, off the path of the suite's longest file.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.flow.flownet2 import FlowNet2 as JFlowNet2

from test_torch_port_modules import T, _bridge, _close
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.flow.flownet2 import FlowNet2


def test_flownet2():
    rng = np.random.default_rng(2)
    a = (rng.random((1, 64, 64, 3)) * 255).astype(np.float32)
    b = np.clip(a + rng.standard_normal((1, 64, 64, 3)) * 10, 0, 255
                ).astype(np.float32)
    jm = JFlowNet2(compute_dtype=None)
    pm = FlowNet2(compute_dtype=None, device="meta")  # no init: values assigned
    assert sum(p.numel() for p in pm.parameters()) == 162_518_834
    v = _bridge(jm, "flownet2", pm, jnp.asarray(a), jnp.asarray(b))
    assert all(p.device.type == "cpu" for p in pm.state_dict().values())
    want = jax.jit(jm.apply)(v, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = pm(T(a), T(b))
    _close(got.numpy(), want)
