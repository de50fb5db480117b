"""Port parity, the weight bridge: build_sd -> vps_tpu's convert_detector
-> vps_torch's state_dict_from_jax gives back every key of build_sd, bit
for bit, and loads strictly into the port's FuseTrack.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np

from test_torch_port_fusetrack import _cfgs, build_weights
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import PanopticFuseTrack


def test_weight_bridge_round_trip():
    sd, params, stats, used, _ = build_weights()
    assert used == set(sd)
    back = state_dict_from_jax(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    cfg, tcfg = _cfgs(zoo)
    cfg["flow"] = dict(compute_dtype="float32")  # full FlowNet2 keys absent
    port = PanopticFuseTrack(test_cfg=tcfg, device="cpu", **cfg)
    missing, unexpected = port.load_state_dict(back, strict=False)
    assert not unexpected
    assert all(k.startswith("flownet2.") for k in missing)
