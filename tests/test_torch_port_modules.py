"""Port parity, modules: each vps_torch module against its vps_tpu module on
the same weights and seeded numpy inputs, on the CPU, f32 (the `exact`
preset's compute).

JAX variables come from ``jax.eval_shape`` of ``init`` filled with seeded
numpy values (a full flax init of FlowNet2 alone costs minutes); the port
loads them through ``vps_torch.convert.state_dict_from_jax``, so the weight
bridge is exercised on every module. Tolerance: max |diff| <= 1e-4 of the
output's max magnitude (+1e-5), i.e. agreement to summation order through
tens of f32 layers. FlowNet2's comparison lives in a one-test file of its
own, ``test_torch_port_flownet2.py`` (pytest-xdist's loadfile scheduler
queues a one-test file after the files with several).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.bbox_head import SharedFCBBoxHead as JBBoxHead
from vps_tpu.models.bfp_tcea import BFPTcea as JBFPTcea
from vps_tpu.models.detectors.panoptic_ops import (
    TrackState as JTrackState,
    mask_removal_and_fuse as j_mask_removal_and_fuse,
    panoptic_dets as j_panoptic_dets,
    track_assign as j_track_assign,
)
from vps_tpu.models.fpn import FPN as JFPN
from vps_tpu.models.mask_head import FCNMaskHead as JMaskHead
from vps_tpu.models.panoptic_fpn import UPSNetFPN as JUPSNetFPN
from vps_tpu.models.resnet import ResNet as JResNet
from vps_tpu.models.rpn_head import RPNHead as JRPNHead
from vps_tpu.models.rpn_head import rpn_proposals as j_rpn_proposals
from vps_tpu.models.track_head import TrackHead as JTrackHead
from vps_tpu.ops.anchors import AnchorGenerator as JAnchorGenerator

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.convert import state_dict_from_jax
from vps_torch.models.bbox_head import SharedFCBBoxHead
from vps_torch.models.bfp_tcea import BFPTcea
from vps_torch.models.detectors.panoptic_ops import (
    TrackState,
    mask_removal_and_fuse,
    panoptic_dets,
    track_assign,
)
from vps_torch.models.fpn import FPN
from vps_torch.models.mask_head import FCNMaskHead
from vps_torch.models.panoptic_fpn import UPSNetFPN
from vps_torch.models.resnet import ResNet
from vps_torch.models.rpn_head import RPNHead, rpn_proposals
from vps_torch.models.track_head import TrackHead
from vps_torch.ops.anchors import AnchorGenerator

T = torch.from_numpy


def _fill(tree, rng):
    """Seeded values for an eval_shape tree: fan-in scaled kernels, norm
    scales near 1, small biases / offsets, BN stats near (0, 1)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, rng)
            continue
        shape = tuple(v.shape)
        z = rng.standard_normal(shape, dtype=np.float32)
        if k in ("kernel", "weight"):
            fan = int(np.prod(shape[:-1]))
            out[k] = z * np.float32(1.4 / np.sqrt(fan))
        elif k == "scale":
            out[k] = 1.0 + 0.1 * z
        elif k == "var":
            out[k] = 1.0 + 0.1 * np.abs(z)
        else:  # bias, mean
            out[k] = 0.1 * z
    return out


def _bridge(jmod, prefix, port, *args, method=None, seed=0, variables=None):
    """eval_shape-init `jmod`, fill, load the same values into `port` (which
    may be built on the meta device: the values are assigned). Returns the
    flax variables. ``variables``: a module's of the same parameter tree,
    filled already (no init trace)."""
    if variables is None:
        shapes = jax.eval_shape(
            lambda: jmod.init(jax.random.PRNGKey(0), *args, method=method))
        rng = np.random.default_rng(seed)
        variables = {k: _fill(v, rng) for k, v in shapes.items()}
    sd = state_dict_from_jax({prefix: variables["params"]},
                             {prefix: variables.get("batch_stats", {})})
    port.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()},
                         strict=True, assign=True)
    return variables


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-5)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_resnet50():
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    jm = JResNet(depth=50)
    pm = ResNet(50, device="cpu")
    v = _bridge(jm, "backbone", pm, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(T(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_resnet18_fpn_bf16():
    """The half-flow trunk: ResNet + FPN computing in bf16 (params f32, FPN
    outputs f32). Both sides round every conv output to bf16 (2^-8
    relative) but accumulate in another order, so results drift by bf16
    ulps over the ~20 bf16 layers: mean |diff| <= 2% of mean |ref|, max
    |diff| <= 3% of max |ref|."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    jr, jf = JResNet(depth=18, dtype=jnp.bfloat16), JFPN(
        in_channels=(64, 128, 256, 512), dtype=jnp.bfloat16)
    pr = ResNet(18, dtype=torch.bfloat16, device="cpu")
    pf = FPN((64, 128, 256, 512), dtype=torch.bfloat16, device="cpu")
    vr = _bridge(jr, "backbone", pr, jnp.asarray(x))
    c = jax.jit(jr.apply)(vr, jnp.asarray(x))
    vf = _bridge(jf, "neck", pf, list(c))
    want = jax.jit(jf.apply)(vf, list(c))
    with torch.no_grad():
        got = pf(pr(T(x).permute(0, 3, 1, 2)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        g, w = _nhwc(g), np.asarray(w)
        d = np.abs(g - w)
        assert d.mean() <= 2e-2 * np.abs(w).mean(), d.mean()
        assert d.max() <= 3e-2 * np.abs(w).max(), d.max()


def test_fpn():
    rng = np.random.RandomState(1)
    chans = (256, 512, 1024, 2048)
    xs = [rng.randn(1, 16 >> i, 24 >> i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    jm = JFPN(in_channels=chans)
    pm = FPN(chans, device="cpu")
    v = _bridge(jm, "neck", pm, [jnp.asarray(x) for x in xs])
    want = jm.apply(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_bfp_tcea():
    rng = np.random.RandomState(3)
    sizes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    cur = [rng.randn(1, h, w, 256).astype(np.float32) for h, w in sizes]
    ref = [rng.randn(1, h, w, 256).astype(np.float32) for h, w in sizes]
    flow = rng.uniform(-2, 2, (1, 16, 32, 2)).astype(np.float32)
    jm = JBFPTcea(compute_dtype=None)
    pm = BFPTcea(compute_dtype=None, device="cpu")
    jargs = ([jnp.asarray(x) for x in cur], [jnp.asarray(x) for x in ref],
             jnp.asarray(flow))
    v = _bridge(jm, "extra_neck", pm, *jargs)
    want = jax.jit(jm.apply)(v, *jargs)
    nchw = lambda xs: [T(x).permute(0, 3, 1, 2) for x in xs]  # noqa: E731
    with torch.no_grad():
        got = pm(nchw(cur), nchw(ref), T(flow))
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


_UPSNET_VARIABLES = {}  # (cin, cout, dcn_window) -> filled flax variables


@pytest.mark.parametrize("head_stride,dcn_window", [
    pytest.param(4, None, id="4"), pytest.param(8, None, id="8"),
    pytest.param(4, 4, id="4-window4")])
def test_upsnet_fpn(head_stride, dcn_window):
    """``dcn_window`` runs every level through the clamped DCN, at narrow
    widths (64 -> 32 channels; GroupNorm(32) still has two and one
    channels a group). The head stride changes no parameter, so the
    strides share one filled tree (the values a fill of each would give)."""
    cin, cout = (256, 128) if dcn_window is None else (64, 32)
    rng = np.random.RandomState(4)
    xs = [rng.randn(1, 16 >> i, 32 >> i, cin).astype(np.float32)
          for i in range(4)]
    kw = dict(in_channels=cin, out_channels=cout, compute_dtype=None,
              head_stride=head_stride, dcn_window=dcn_window)
    jm = JUPSNetFPN(**kw)
    pm = UPSNetFPN(device="cpu", **kw)
    key = (cin, cout, dcn_window)
    v = _UPSNET_VARIABLES[key] = _bridge(
        jm, "panopticFPN", pm, [jnp.asarray(x) for x in xs],
        variables=_UPSNET_VARIABLES.get(key))
    want_out, want_score = jax.jit(jm.apply)(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        out, score = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    _close(_nhwc(score), want_score)
    _close(_nhwc(out), want_out)


def test_rpn_head_and_proposals():
    rng = np.random.RandomState(5)
    h, w = 64, 96
    xs = [rng.randn(1, h // s, w // s, 256).astype(np.float32)
          for s in (4, 8, 16, 32, 64)]
    jm = JRPNHead()
    pm = RPNHead(device="cpu")
    v = _bridge(jm, "rpn_head", pm, [jnp.asarray(x) for x in xs])
    jcls, jreg = jax.jit(jm.apply)(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        pcls, preg = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    for g, wnt in zip(pcls + preg, list(jcls) + list(jreg)):
        _close(_nhwc(g), wnt)
    strides = (4, 8, 16, 32, 64)
    janchors = [JAnchorGenerator(s, [8], [0.5, 1.0, 2.0]).grid_anchors(
        c.shape[1:3], s) for s, c in zip(strides, jcls)]
    panchors = [AnchorGenerator(s, [8], [0.5, 1.0, 2.0]).grid_anchors(
        tuple(c.shape[-2:]), s) for s, c in zip(strides, pcls)]
    for pa, ja in zip(panchors, janchors):
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    # feed both decoders the SAME (JAX) head outputs: selection is discrete
    want = jax.jit(lambda c, r, a: j_rpn_proposals(
        c, r, a, (h, w), nms_pre=200, max_num=100))(
        [c[0] for c in jcls], [r[0] for r in jreg], janchors)
    got = rpn_proposals([T(np.array(c[0])) for c in jcls],
                        [T(np.array(r[0])) for r in jreg], panchors, (h, w),
                        nms_pre=200, max_num=100)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)


def test_bbox_mask_track_heads():
    rng = np.random.RandomState(6)
    r7 = rng.randn(5, 7, 7, 256).astype(np.float32)
    r14 = rng.randn(3, 14, 14, 256).astype(np.float32)
    ref7 = rng.randn(4, 7, 7, 256).astype(np.float32)
    ref_valid = np.array([True, False, True, True])

    jb, pb = JBBoxHead(), SharedFCBBoxHead(device="cpu")
    v = _bridge(jb, "bbox_head", pb, jnp.asarray(r7))
    want_cls, want_reg = jb.apply(v, jnp.asarray(r7))
    jm, pmh = JMaskHead(), FCNMaskHead(device="cpu")
    vm = _bridge(jm, "mask_head", pmh, jnp.asarray(r14))
    want_mask = jm.apply(vm, jnp.asarray(r14))
    jt, pt = JTrackHead(), TrackHead(device="cpu")
    vt = _bridge(jt, "track_head", pt, jnp.asarray(r7), jnp.asarray(ref7),
                 jnp.asarray(ref_valid))
    want_match = jt.apply(vt, jnp.asarray(r7), jnp.asarray(ref7),
                          jnp.asarray(ref_valid))
    with torch.no_grad():
        cls, reg = pb(T(r7))
        mask = pmh(T(r14))
        match = pt(T(r7), T(ref7), T(ref_valid))
    _close(cls.numpy(), want_cls)
    _close(reg.numpy(), want_reg)
    _close(_nhwc(mask), want_mask)
    _close(match.numpy(), want_match)


def test_panoptic_tail_ops():
    """panoptic_dets, mask_removal_and_fuse and track_assign on identical
    inputs: identical selections, keep sets, maps and track ids."""
    rng = np.random.RandomState(7)
    n, k = 40, 9
    xy = rng.uniform(0, 80, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1
                          ).astype(np.float32)
    valid = rng.rand(n) > 0.1
    prob = rng.dirichlet(np.full(k, 0.3), n).astype(np.float32)
    deltas = (rng.randn(n, 4 * k) * 0.5).astype(np.float32)
    jd = jax.jit(functools.partial(j_panoptic_dets, img_shape=(96, 128),
                                   score_thresh=0.3, top_n=16))(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(prob),
        jnp.asarray(deltas))
    pd = panoptic_dets(T(rois), T(valid), T(prob), T(deltas), (96, 128),
                       score_thresh=0.3, top_n=16)
    np.testing.assert_array_equal(pd[3].numpy(), np.asarray(jd[3]))
    np.testing.assert_array_equal(pd[2].numpy(), np.asarray(jd[2]))
    np.testing.assert_allclose(pd[0].numpy(), np.asarray(jd[0]), atol=1e-4)
    boxes, probs, cls, dvalid = (np.array(a) for a in jd)
    assert dvalid.sum() >= 4

    cap = 8
    comp = rng.randn(16, cap + 1).astype(np.float32)
    mem_valid = np.arange(cap) < 5
    comp[:, 1:][:, ~mem_valid] = -np.inf
    comp[3, 2] = comp[5, 2] = 50.0  # two dets compete for memory slot 1
    feats = rng.randn(16, 7, 7, 4).astype(np.float32)
    labels = rng.randint(0, 8, 16).astype(np.int32)
    st = (rng.randn(cap, 7, 7, 4).astype(np.float32),
          rng.uniform(0, 50, (cap, 4)).astype(np.float32),
          rng.randint(0, 8, cap).astype(np.int32), mem_valid, np.int32(5))
    jids, jst = jax.jit(j_track_assign)(
        jnp.asarray(comp), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(feats), jnp.asarray(dvalid),
        JTrackState(*(jnp.asarray(a) for a in st)))
    pids, pst = track_assign(T(comp), T(boxes), T(labels), T(feats), T(dvalid),
                             TrackState(*(torch.as_tensor(a) for a in st)))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    for a, b in zip(pst, jst):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    mask28 = rng.randn(16, 28, 28).astype(np.float32)
    fcn = rng.randn(96, 128, 19).astype(np.float32)
    jf = jax.jit(j_mask_removal_and_fuse)(
        jnp.asarray(boxes), jnp.asarray(probs), jnp.asarray(cls),
        jnp.asarray(dvalid), jids, jnp.asarray(mask28), jnp.asarray(fcn))
    pf = mask_removal_and_fuse(
        T(boxes), T(probs), T(cls), T(dvalid), pids, T(mask28),
        T(np.ascontiguousarray(fcn.transpose(2, 0, 1))))
    assert int(pf.num_keep) == int(jf.num_keep) >= 2
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
