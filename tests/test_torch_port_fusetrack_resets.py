"""Port, predict_video's reset semantics: a reset frame clears the track
state, is its own reference and recomputes the feature carry, so the clip
[a, b(reset)] gives b the same outputs as a fresh clip [b(reset)].

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import torch

from test_torch_port_fusetrack import CAP, H, W, _cfgs, build_weights
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import (
    PanopticFuseTrack,
    empty_track_state,
    predict_video,
)


def test_predict_video_resets():
    cfg, tcfg = _cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=tcfg, device="cpu", **cfg)
    sd = state_dict_from_jax(*build_weights()[1:3])
    torch.manual_seed(0)
    for name in ("c1", "c2", "pred"):
        conv = getattr(port.flownet2, name)
        sd[f"flownet2.{name}.weight"] = torch.randn_like(conv.weight) * 0.1
        sd[f"flownet2.{name}.bias"] = torch.zeros_like(conv.bias)
    port.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randn(1, 1, H, W, 3).astype(np.float32))
            for _ in range(2))
    empty = empty_track_state(CAP, device="cpu")
    two, (state2, _, last) = predict_video(port, torch.cat([a, b]),
                                           [True, True], empty, a[0])
    one, (state1, _, _) = predict_video(port, b, [True], empty, a[0])
    assert torch.equal(last, b[0])
    for k in one:
        torch.testing.assert_close(two[k][1], one[k][0], rtol=0, atol=0)
    for x, y in zip(state2, state1):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
