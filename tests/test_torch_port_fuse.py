"""Port parity, PanopticFuse (flow fusion, no track head): vps_torch's video
inference held against vps_tpu's ``predict`` on a 2-frame clip (64x128,
ResNet-18 trunk, TinyFlow, `exact` preset, f32) with the same weights, to
``assert_frame_matches``'s bar: identical detections, keep sets and object
ids (the running count of each frame's valid detections), >= 0.999
semantic and panoptic agreement.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several. ``clip_pair`` serves test_torch_port_track.py too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu import zoo as jzoo
from vps_tpu.models import detectors as jdetectors
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_fusetrack import CAP, _cfgs, _weights, assert_frame_matches
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import (
    build_detector,
    empty_track_state,
    predict_video,
)
from vps_torch.models.detectors.panoptic import DETECTORS

H, W = 64, 128


def clip_pair(kind, absent):
    """A 2-frame clip (each frame's reference the frame before) through
    vps_tpu's ``kind`` detector, one jitted ``predict`` per frame, and
    through the port's ``predict_video``; the towers in ``absent`` set to
    None in the config and their weights left out of both. Returns (JAX
    per-frame outputs, port per-frame outputs, port final TrackState)."""
    rng = np.random.RandomState(3)
    params_conv, stats_conv, _ = convert_detector(build_sd(rng), depth=18)
    params, stats = _weights(params_conv, stats_conv)
    params = {k: v for k, v in params.items()
              if k not in absent and not (k == "flownet2"
                                          and "extra_neck" in absent)}
    cfg, tcfg = _cfgs(jzoo)
    cfg.update({k: None for k in absent})
    det = getattr(jdetectors, kind)(train_cfg=jzoo.fusetrack_train_cfg(),
                                    test_cfg=tcfg, **cfg)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    img1 = (0.7 * img0 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    img2 = (0.7 * img1 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    state = jdetectors.empty_track_state(cap=CAP)
    predict = jax.jit(lambda v, im, ref, st: det.apply(
        v, im, ref, st, method=det.predict))
    ours = []
    for im, ref in ((img1, img0), (img2, img1)):
        out, state = predict({"params": params, "batch_stats": stats},
                             jnp.asarray(im), jnp.asarray(ref), state)
        ours.append(jax.device_get(out))

    pcfg, ptcfg = _cfgs(zoo)
    pcfg.update({k: None for k in absent}, type=kind)
    port = build_detector(pcfg, test_cfg=ptcfg, device="cpu")
    assert type(port) is DETECTORS[kind]
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    theirs, (pstate, _, _) = predict_video(
        port, torch.from_numpy(np.stack([img1, img2])), [False, False],
        empty_track_state(CAP, device="cpu"), torch.from_numpy(img0))
    theirs = {k: v.numpy() for k, v in theirs.items()}
    return ours, [{k: v[t] for k, v in theirs.items()} for t in range(2)], \
        pstate


def test_fuse_clip_matches_jax():
    """Both frames to assert_frame_matches's bar; no track head: object
    ids 0..n-1 over each frame's valid dets, the track state untouched."""
    ours, port, state = clip_pair("PanopticFuse", ("track_head",))
    for jframe, pframe in zip(ours, port):
        assert_frame_matches(jframe, pframe)
        nk = int(jframe["num_keep"])
        ids = pframe["panoptic_det_obj_ids"][:nk]
        assert sorted(ids.tolist()) == sorted(set(ids.tolist()))
        assert ids.max() < int(pframe["det_valid"].sum())
    assert int(state.count) == 0 and not bool(state.valid.any())
