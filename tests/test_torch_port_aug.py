"""Port parity, test-time augmentation: vps_torch's
``PanopticFuseTrack.predict_aug`` held against vps_tpu's on one frame with
3 variants on one 64x128 canvas (the frame, its flip, the frame at half
scale in the canvas' top-left corner), the tiny `exact` FuseTrack, f32, the
same weights, to ``assert_frame_matches``'s bar: identical merged
detections, keep sets and track ids, >= 0.999 semantic and panoptic
agreement. The merged inputs of the panoptic fusion are compared too, as
the maps alone barely see the mask merge when few dets are kept: the mean
semantic logits (rtol 1e-4, atol 1e-3: f32 sums in other orders through
the trunk and the deformable tower) and each valid det's mean mask
probability (atol 5e-3: the dets' boxes agree within 2e-2 px, and the mask
RoIs sample where the boxes say; a flip left undone moves them by ~0.5).

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import vps_tpu.models.detectors.panoptic as jpanoptic
from vps_tpu import zoo as jzoo
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack
from vps_tpu.models.detectors import empty_track_state as j_empty_track_state
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_fusetrack import CAP, _cfgs, _weights, assert_frame_matches
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_torch.models.detectors.panoptic as tpanoptic
from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import PanopticFuseTrack, empty_track_state

H, W = 64, 128
METAS = (dict(flip=False, scale_ratio=1.0, img_shape=(H, W)),
         dict(flip=True, scale_ratio=1.0, img_shape=(H, W)),
         dict(flip=False, scale_ratio=0.5, img_shape=(H // 2, W // 2)))


def _variant(src, meta):
    """``src`` (H, W, 3) resized by the variant's ratio (bilinear), flipped
    within its content if asked, in the top-left corner of the canvas."""
    hv, wv = meta["img_shape"]
    v = cv2.resize(src, (wv, hv), interpolation=cv2.INTER_LINEAR)
    if meta["flip"]:
        v = v[:, ::-1]
    canvas = np.zeros((H, W, 3), np.float32)
    canvas[:hv, :wv] = v
    return canvas


def test_predict_aug_matches_jax():
    rng = np.random.RandomState(3)
    params_conv, stats_conv, _ = convert_detector(build_sd(rng), depth=18)
    params, stats = _weights(params_conv, stats_conv)
    img = rng.randn(H, W, 3).astype(np.float32)
    ref = (0.7 * img + 0.3 * rng.randn(H, W, 3)).astype(np.float32)
    imgs = np.stack([_variant(img, m) for m in METAS])[:, None]
    refs = np.stack([_variant(ref, m) for m in METAS])[:, None]

    fused = {}  # the fusion's merged inputs: (mask logits, semantic logits)
    j_fuse, t_fuse = jpanoptic.mask_removal_and_fuse, tpanoptic.mask_removal_and_fuse

    def j_record(*args, **kw):  # traced values, returned by the jitted call
        fused["jax"] = (args[5], args[6])
        return j_fuse(*args, **kw)

    def t_record(*args, **kw):
        fused["port"] = (args[5].numpy(), args[6].numpy())
        return t_fuse(*args, **kw)

    cfg, tcfg = _cfgs(jzoo)
    det = JPanopticFuseTrack(train_cfg=jzoo.fusetrack_train_cfg(),
                             test_cfg=tcfg, **cfg)
    pcfg, ptcfg = _cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=ptcfg, device="cpu", **pcfg)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpanoptic, "mask_removal_and_fuse", j_record)
        mp.setattr(tpanoptic, "mask_removal_and_fuse", t_record)
        ours, jstate, fused["jax"] = jax.device_get(jax.jit(
            lambda v, a, b, st: det.apply(v, a, b, st, METAS,
                                          method=det.predict_aug) + (
                fused["jax"],))(
            {"params": params, "batch_stats": stats}, jnp.asarray(imgs),
            jnp.asarray(refs), j_empty_track_state(cap=CAP)))
        theirs, state = port.predict_aug(
            torch.from_numpy(imgs), torch.from_numpy(refs),
            empty_track_state(CAP, device="cpu"), METAS)
    assert "fpn_feats" not in theirs
    assert_frame_matches(ours, {k: v.numpy() for k, v in theirs.items()})
    valid = ours["det_valid"]
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    np.testing.assert_allclose(sig(fused["port"][0][valid]),
                               sig(fused["jax"][0][valid]), rtol=0, atol=5e-3)
    np.testing.assert_allclose(fused["port"][1],
                               fused["jax"][1].transpose(2, 0, 1),
                               rtol=1e-4, atol=1e-3)
    assert int(state.count) == int(jstate.count)
    np.testing.assert_array_equal(state.valid.numpy(), np.asarray(jstate.valid))
