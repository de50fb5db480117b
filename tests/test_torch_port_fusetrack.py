"""Port parity, the whole slice: the shared pieces of the FuseTrack clip
tests (vps_torch's FuseTrack video inference held against vps_tpu's
``predict`` on a 2-frame clip, 64x128, ResNet-18 trunk, TinyFlow, `exact`
preset, f32, with the same weights, asserting what
tests/test_full_graph_parity.py asserts). The clip's frames, the weight
bridge round trip and predict_video's reset semantics are one-test files of
their own (``test_torch_port_fusetrack_frame0.py``, ``_frame1``,
``_bridge``, ``_resets``), the static no-JAX-import check is
``test_torch_port_all_imports.py``: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so one-test files start
after the files with several and leave the suite's wall where it is.

Cost: JAX variables come from ``convert_detector`` and seeded TinyFlow
convs (no init and no trace of the detector), and one jitted ``predict`` is
reused for both frames.
"""


import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu import zoo as jzoo
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack
from vps_tpu.models.detectors import empty_track_state as j_empty_track_state
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import _merge, build_sd
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import (
    PanopticFuseTrack,
    empty_track_state,
    predict_video,
)

H, W = 64, 128
CAP = 64
RPN_CFG = dict(nms_pre=128, nms_post=128, max_num=64, nms_thr=0.7)
PANO_CFG = dict(score_thresh=0.20, nms_thresh=0.5, max_det=12)


def _cfgs(zoo_mod):
    cfg = zoo_mod.exact_overrides(zoo_mod.tiny_overrides(
        zoo_mod.fusetrack_model_cfg()))
    cfg.pop("type")
    tcfg = zoo_mod.fusetrack_test_cfg()
    tcfg["rpn"].update(RPN_CFG)
    tcfg["panoptic"].update(PANO_CFG)
    return cfg, tcfg


def _fill(tree, rng):
    """Seeded values for every leaf of a tree of arrays (the TinyFlow
    weights, which convert_detector does not cover, keep these)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            fan = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = np.ones(v.shape, np.float32)
        else:
            out[k] = np.zeros(v.shape, np.float32)
    return out


def _weights(params_conv, stats_conv):
    """The JAX variables: build_sd's through convert_detector, and TinyFlow's
    three convs (which convert_detector does not cover) from _fill with
    seed 7 over the tree in flax's sorted key order, as an eval_shape of
    the detector's init would give it, without tracing the detector."""
    tiny = {n: {"Conv_0": {"bias": np.zeros((o,), np.float32),
                           "kernel": np.zeros((3, 3, i, o), np.float32)}}
            for n, i, o in (("c1", 6, 16), ("c2", 16, 16), ("pred", 16, 2))}
    frng = np.random.RandomState(7)
    params = _merge(_fill(dict(sorted({**params_conv, "flownet2": tiny}.items())),
                          frng), params_conv)
    stats = _merge(_fill(dict(stats_conv), frng), stats_conv)
    return jax.tree.map(np.asarray, (params, stats))


def build_weights():
    """One build_sd (seed 3) and its conversion: (state_dict, params,
    batch_stats, keys used, the rng's state after the draws)."""
    rng = np.random.RandomState(3)
    sd = build_sd(rng)
    params_conv, stats_conv, used = convert_detector(sd, depth=18)
    return sd, params_conv, stats_conv, used, rng.get_state()


def run_clip(frames):
    """The first ``frames`` (1 or 2) frames of the clip through both
    stacks; returns (JAX per-frame outputs, port outputs stacked over
    frames)."""
    _, params_conv, stats_conv, _, rng_state = build_weights()
    rng = np.random.RandomState()
    rng.set_state(rng_state)
    cfg, tcfg = _cfgs(jzoo)
    det = JPanopticFuseTrack(train_cfg=jzoo.fusetrack_train_cfg(),
                             test_cfg=tcfg, **cfg)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    img1 = (0.7 * img0 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    img2 = (0.7 * img1 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    pairs = ((img1, img0), (img2, img1))[:frames]
    state = j_empty_track_state(cap=CAP)
    params, stats = _weights(params_conv, stats_conv)
    predict = jax.jit(lambda v, im, ref, st: det.apply(
        v, im, ref, st, method=det.predict))
    ours = []
    for im, ref in pairs:
        out, state = predict({"params": params, "batch_stats": stats},
                             jnp.asarray(im), jnp.asarray(ref), state)
        ours.append(jax.device_get(out))

    pcfg, ptcfg = _cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=ptcfg, device="cpu", **pcfg)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    theirs, _ = predict_video(
        port, torch.from_numpy(np.stack([im for im, _ in pairs])),
        [False] * frames, empty_track_state(CAP, device="cpu"),
        torch.from_numpy(img0))
    return ours, {k: v.numpy() for k, v in theirs.items()}


def assert_frame_matches(ours, p):
    """One frame of the port (``p``) against JAX's ``predict`` (``ours``):
    identical detections, keep sets and track ids, >= 0.999 agreement."""
    nvalid = int(ours["det_valid"].sum())
    assert nvalid >= 3, f"too few detections ({nvalid})"
    np.testing.assert_array_equal(p["det_valid"], ours["det_valid"])
    np.testing.assert_array_equal(p["det_labels"][:nvalid],
                                  ours["det_labels"][:nvalid])
    np.testing.assert_allclose(p["det_probs"][:nvalid],
                               ours["det_probs"][:nvalid], atol=1e-3)
    np.testing.assert_allclose(p["det_bboxes"][:nvalid],
                               ours["det_bboxes"][:nvalid], atol=2e-2)
    nk = int(ours["num_keep"])
    assert int(p["num_keep"]) == nk and nk >= 1
    np.testing.assert_array_equal(p["panoptic_valid"], ours["panoptic_valid"])
    np.testing.assert_array_equal(p["panoptic_cls_inds"][:nk],
                                  ours["panoptic_cls_inds"][:nk])
    np.testing.assert_array_equal(p["panoptic_det_obj_ids"][:nk],
                                  ours["panoptic_det_obj_ids"][:nk])
    assert p["fcn_outputs"].shape == ours["fcn_outputs"].shape == (H, W)
    sseg = float(np.mean(p["fcn_outputs"] == ours["fcn_outputs"]))
    pan = float(np.mean(p["panoptic_outputs"] == ours["panoptic_outputs"]))
    assert sseg >= 0.999, f"semantic agreement {sseg}"
    assert pan >= 0.999, f"panoptic agreement {pan}"
