"""Port parity, the whole slice: vps_torch's FuseTrack video inference held
against vps_tpu's ``predict`` on a 2-frame clip (64x128, ResNet-18 trunk,
TinyFlow, `exact` preset, f32) with the same weights, asserting what
tests/test_full_graph_parity.py asserts. Plus the weight bridge round trip,
predict_video's reset semantics, and the static no-JAX-import check.

Cost: JAX variables come from ``convert_detector`` and seeded TinyFlow
convs (no init and no trace of the detector), one build_sd serves the
file's tests, and one jitted ``predict`` is reused for both frames in a
module-scoped fixture.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
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
REPO = Path(__file__).resolve().parent.parent


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


@pytest.fixture(scope="module")
def weights():
    """The file's one build_sd (seed 3) and its conversion: (state_dict,
    params, batch_stats, keys used, the rng's state after the draws)."""
    rng = np.random.RandomState(3)
    sd = build_sd(rng)
    params_conv, stats_conv, used = convert_detector(sd, depth=18)
    return sd, params_conv, stats_conv, used, rng.get_state()


@pytest.fixture(scope="module")
def clip(weights):
    """Both stacks on one clip; returns (JAX per-frame outputs, port stacked
    outputs)."""
    _, params_conv, stats_conv, _, rng_state = weights
    rng = np.random.RandomState()
    rng.set_state(rng_state)
    cfg, tcfg = _cfgs(jzoo)
    det = JPanopticFuseTrack(train_cfg=jzoo.fusetrack_train_cfg(),
                             test_cfg=tcfg, **cfg)
    img0 = rng.randn(1, H, W, 3).astype(np.float32)
    img1 = (0.7 * img0 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    img2 = (0.7 * img1 + 0.3 * rng.randn(1, H, W, 3)).astype(np.float32)
    state = j_empty_track_state(cap=CAP)
    params, stats = _weights(params_conv, stats_conv)
    predict = jax.jit(lambda v, im, ref, st: det.apply(
        v, im, ref, st, method=det.predict))
    ours = []
    for im, ref in ((img1, img0), (img2, img1)):
        out, state = predict({"params": params, "batch_stats": stats},
                             jnp.asarray(im), jnp.asarray(ref), state)
        ours.append(jax.device_get(out))

    pcfg, ptcfg = _cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=ptcfg, device="cpu", **pcfg)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    theirs, _ = predict_video(
        port, torch.from_numpy(np.stack([img1, img2])), [False, False],
        empty_track_state(CAP, device="cpu"), torch.from_numpy(img0))
    return ours, {k: v.numpy() for k, v in theirs.items()}


@pytest.mark.parametrize("frame", [0, 1])
def test_fusetrack_clip_matches_jax(clip, frame):
    ours_all, port = clip
    assert_frame_matches(ours_all[frame], {k: v[frame] for k, v in port.items()})


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


def test_weight_bridge_round_trip(weights):
    """build_sd -> convert_detector -> state_dict_from_jax gives back every
    key of build_sd, bit for bit, and loads strictly into the port."""
    sd, params, stats, used, _ = weights
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


def test_predict_video_resets(weights):
    """A reset frame clears the track state, is its own reference and
    recomputes the feature carry: the clip [a, b(reset)] gives b the same
    outputs as a fresh clip [b(reset)]."""
    cfg, tcfg = _cfgs(zoo)
    port = PanopticFuseTrack(test_cfg=tcfg, device="cpu", **cfg)
    sd = state_dict_from_jax(*weights[1:3])
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


def test_port_imports_no_jax():
    """vps_torch and chip_smoke.py import nothing of jax, flax, optax or
    vps_tpu (static check over every module's import statements), the
    training, data, eval, tools, utils and config modules included."""
    banned = ("jax", "jaxlib", "flax", "optax", "vps_tpu")
    files = sorted((REPO / "vps_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {p.relative_to(REPO).as_posix() for p in files}
    required = {f"vps_torch/{m}.py" for m in (
        "core/assigner", "core/sampler", "core/targets", "ops/losses",
        "ops/mask", "train/optim", "train/step", "train/runner",
        "utils/checkpoint", "utils/numerics", "config", "data/coco",
        "data/transforms", "data/dataset", "data/loader", "data/synth",
        "eval/pq", "eval/vpq", "eval/unified", "train/eval_hook",
        "tools/train", "tools/test_vpq", "tools/eval_vpq",
        "configs/cityscapes/fusetrack", "configs/cityscapes/fusetrack_fast",
        "configs/cityscapes/fuse", "configs/cityscapes/track",
        "configs/viper/fusetrack", "eval/viper", "tools/eval_ipq",
        "utils/visualize", "utils/flow")}
    assert required <= names, required - names
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
