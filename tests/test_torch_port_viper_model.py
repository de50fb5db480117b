"""Port parity, VIPER's model: the tiny FuseTrack built from the port's
``vps_torch/configs/viper/fusetrack.py`` (VIPER's heads: 23 semantic
classes, 10 things, ``num_classes=11`` for the bbox and mask heads, the
``class_mapping`` in its train and test configs) held against vps_tpu's,
built from the repo's ``configs/viper/fusetrack.py``, on a 2-frame clip
(64x128, ResNet-18 trunk, TinyFlow, `exact` preset, f32) with the same
weights, to ``assert_frame_matches``'s bar: identical detections, keep sets
and track ids, >= 0.999 semantic and panoptic agreement; and the panoptic
fusion alone with VIPER's class counts, on logits where a thing's semantic
channel decides pixels, identical to vps_tpu's.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu import zoo as jzoo
from vps_tpu.config import Config as JConfig
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack
from vps_tpu.models.detectors import empty_track_state as j_empty_track_state
from vps_tpu.models.detectors.panoptic_ops import (
    mask_removal_and_fuse as j_mask_removal_and_fuse,
)
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_fusetrack import (
    CAP,
    PANO_CFG,
    RPN_CFG,
    _weights,
    assert_frame_matches,
)
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.config import Config
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    predict_video,
)
from vps_torch.models.detectors.panoptic_ops import mask_removal_and_fuse

REPO = Path(__file__).resolve().parent.parent
H, W = 64, 128
C_DET, NUM_SEG, NUM_STUFF = 11, 23, 13


def _viper_sd(rng):
    """build_sd's ResNet-18 FuseTrack with VIPER's class-sized layers drawn
    anew at build_sd's gains: the bbox and mask heads' 11 classes, the
    semantic head's 23."""
    sd = build_sd(rng)

    def put(key, shape, gain, bias_scale):
        fan = int(np.prod(shape[1:]))
        sd[key + ".weight"] = (rng.randn(*shape) * gain / np.sqrt(fan)
                               ).astype(np.float32)
        sd[key + ".bias"] = (rng.randn(shape[0]) * bias_scale
                             ).astype(np.float32)

    put("bbox_head.fc_cls", (C_DET, 1024), 4.0, 1.0)
    put("bbox_head.fc_reg", (C_DET * 4, 1024), 0.4, 0.05)
    put("mask_head.conv_logits", (C_DET, 256, 1, 1), 4.0, 0.3)
    put("panopticFPN.conv_pred.conv", (NUM_SEG, 512, 1, 1), 4.0, 0.5)
    return sd


def _cfgs(zoo_mod, cfg):
    """The tiny exact model of a VIPER config and its test config, with the
    parity tests' proposal and detection caps."""
    model = zoo_mod.exact_overrides(zoo_mod.tiny_overrides(dict(cfg.model)))
    model.pop("type")
    tcfg = dict(cfg.test_cfg)
    tcfg["rpn"] = dict(tcfg["rpn"], **RPN_CFG)
    tcfg["panoptic"] = dict(tcfg["panoptic"], **PANO_CFG)
    return model, tcfg


def test_viper_fusetrack_clip_matches_jax():
    """Both frames of the clip (each frame's reference the frame before)
    to assert_frame_matches's bar, with VIPER's 13 stuff classes and thing
    classes 13..22 in the maps."""
    jcfg = JConfig.fromfile(str(REPO / "configs" / "viper" / "fusetrack.py"))
    pcfg = Config.fromfile(str(REPO / "vps_torch" / "configs" / "viper" /
                               "fusetrack.py"))
    assert pcfg.model == jcfg.model
    assert pcfg.train_cfg["class_mapping"] == jcfg.train_cfg["class_mapping"]
    assert pcfg.test_cfg["class_mapping"] == {i: i + 12 for i in range(1, 11)}

    rng = np.random.RandomState(3)
    params_conv, stats_conv, _ = convert_detector(_viper_sd(rng), depth=18)
    params, stats = _weights(params_conv, stats_conv)
    model, tcfg = _cfgs(jzoo, jcfg)
    # the JAX detector reads no class_mapping (the mapping is arithmetic in
    # its code), and an int-keyed dict among a flax module's attributes
    # fails at apply ("expected str instance, int found"): it gets the
    # configs without it
    det = JPanopticFuseTrack(
        train_cfg={k: v for k, v in jcfg.train_cfg.items()
                   if k != "class_mapping"},
        test_cfg={k: v for k, v in tcfg.items() if k != "class_mapping"},
        **model)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    img1 = (0.7 * img0 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    img2 = (0.7 * img1 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    state = j_empty_track_state(cap=CAP)
    predict = jax.jit(lambda v, im, ref, st: det.apply(
        v, im, ref, st, method=det.predict))
    ours = []
    for im, ref in ((img1, img0), (img2, img1)):
        out, state = predict({"params": params, "batch_stats": stats},
                             jnp.asarray(im), jnp.asarray(ref), state)
        ours.append(jax.device_get(out))

    model, tcfg = _cfgs(zoo, pcfg)
    port = build_detector(model, pcfg.train_cfg, tcfg, device="cpu")
    assert port.panopticFPN.num_stuff_classes == NUM_STUFF
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    theirs, _ = predict_video(
        port, torch.from_numpy(np.stack([img1, img2])), [False, False],
        empty_track_state(CAP, device="cpu"), torch.from_numpy(img0))
    theirs = {k: v.numpy() for k, v in theirs.items()}
    things = 0
    for t in range(2):
        p = {k: v[t] for k, v in theirs.items()}
        assert_frame_matches(ours[t], p)
        nk = int(p["num_keep"])
        # thing labels 1..10 and the map's instance ids past the 13 stuff
        assert ((p["panoptic_cls_inds"][:nk] >= 1)
                & (p["panoptic_cls_inds"][:nk] <= 10)).all()
        assert p["fcn_outputs"].max() < NUM_SEG
        things += int((p["panoptic_outputs"] >= NUM_STUFF).sum())
    assert things > 0

    # the fusion alone with VIPER's 13 stuff and 23 semantic channels, on
    # logits where the semantic term of a thing (its class c's channel,
    # c + 12) decides pixels: identical keep sets and maps
    rng = np.random.RandomState(5)
    n = 16
    xy = rng.uniform(0, 90, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (n, 2))], 1
                           ).astype(np.float32)
    probs = rng.uniform(0.3, 1.0, n).astype(np.float32)
    cls = rng.randint(1, 11, n).astype(np.int32)
    dvalid = rng.rand(n) > 0.2
    ids = np.where(dvalid, np.arange(n), -1).astype(np.int32)
    mask28 = rng.randn(n, 28, 28).astype(np.float32)
    fcn = (rng.randn(96, 128, NUM_SEG) * 2).astype(np.float32)
    jf = jax.jit(functools.partial(j_mask_removal_and_fuse,
                                   num_stuff=NUM_STUFF))(
        *(jnp.asarray(a) for a in (boxes, probs, cls, dvalid, ids, mask28,
                                   fcn)))
    pf = mask_removal_and_fuse(
        *(torch.from_numpy(a) for a in (boxes, probs, cls, dvalid, ids,
                                        mask28)),
        torch.from_numpy(np.ascontiguousarray(fcn.transpose(2, 0, 1))),
        num_stuff=NUM_STUFF)
    assert int(pf.num_keep) == int(jf.num_keep) >= 2
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
