"""Port parity, the weight bridge at full width: each of the six
mmdetection v1.0 configurations that chip_smoke.py runs on the card
(``backbone_configs``: DCN v1, modulated DCN in 4 groups, GCNet, the
empirical attention, ResNeXt-101 32x4d, HRNetV2p-W32 with HRFPN), built by
vps_tpu (``jax.eval_shape`` of ``init``; no init is run) and by the port:
``state_dict_from_jax`` of JAX's variables gives exactly the port's
state_dict names and shapes, and loads with ``strict=True``.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp

from vps_tpu.models import build_detector as _jax_registers  # noqa: F401
from vps_tpu.registry import DETECTORS as JDETECTORS

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import chip_smoke
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import build_detector


def test_full_width_backbone_detectors_load_jax_weights_strictly():
    for name, (_, model, _, test_cfg) in chip_smoke.backbone_configs().items():
        cfg, _ = chip_smoke._zoo_port_cfg(model)
        kind = cfg.pop("type")
        jdet = JDETECTORS.get(kind)(
            test_cfg=test_cfg,
            **{k: v for k, v in cfg.items() if k != "pretrained"})
        shapes = jax.eval_shape(lambda: jdet.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
            method=jdet.predict))
        zeros = {k: jax.tree.map(lambda s: np.zeros(s.shape, np.float32), v)
                 for k, v in shapes.items()}
        sd = state_dict_from_jax(zeros["params"], zeros.get("batch_stats"))
        port = build_detector(dict(cfg, type=kind), test_cfg=test_cfg,
                              device="cpu")
        want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want, name
        port.load_state_dict(sd, strict=True)
