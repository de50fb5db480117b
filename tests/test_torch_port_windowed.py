"""Port parity, the windowed semantic head: one frame of the tiny `exact`
clip (64x128, ResNet-18 trunk, TinyFlow, f32) with ``panoptic.dcn_window =
4``, vps_torch's ``predict_video`` against vps_tpu's ``predict`` on the same
weights, with the asserts of ``test_fusetrack_clip_matches_jax``. On the CPU
both sides take the clamped-gather reference of the windowed DCN.

Its own file, so that a parallel run can give its JAX compile a worker of
its own. JAX variables come from ``convert_detector`` and seeded TinyFlow
convs (``_weights``: no init and no trace of the detector).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vps_tpu import zoo as jzoo
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack
from vps_tpu.models.detectors import empty_track_state as j_empty_track_state
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_fusetrack import CAP, H, W, _cfgs, _weights, assert_frame_matches
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import (
    PanopticFuseTrack,
    empty_track_state,
    predict_video,
)

WINDOW = 4


def _windowed_cfgs(zoo_mod):
    cfg, tcfg = _cfgs(zoo_mod)
    cfg["panoptic"]["dcn_window"] = WINDOW
    return cfg, tcfg


def test_fusetrack_windowed_frame_matches_jax():
    rng = np.random.RandomState(5)
    params_conv, stats_conv, _ = convert_detector(build_sd(rng), depth=18)
    cfg, tcfg = _windowed_cfgs(jzoo)
    det = JPanopticFuseTrack(train_cfg=jzoo.fusetrack_train_cfg(),
                             test_cfg=tcfg, **cfg)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    img1 = (0.7 * img0 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    state = j_empty_track_state(cap=CAP)
    params, stats = _weights(params_conv, stats_conv)
    ours, _ = jax.jit(lambda v, im, ref, st: det.apply(
        v, im, ref, st, method=det.predict))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img1),
        jnp.asarray(img0), state)

    pcfg, ptcfg = _windowed_cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=ptcfg, device="cpu", **pcfg)
    assert port.panopticFPN.deform_convs[0][0].dcn_window == WINDOW
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    theirs, _ = predict_video(port, torch.from_numpy(img1[None]), [False],
                              empty_track_state(CAP, device="cpu"),
                              torch.from_numpy(img0))
    assert_frame_matches(jax.device_get(ours),
                         {k: v[0].numpy() for k, v in theirs.items()})
