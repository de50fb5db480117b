"""Shared pieces of the R-CNN zoo's parity tests
(``tests/test_torch_port_zoo_*.py``): the tiny configs of
tests/test_two_stage.py and tests/test_cascade.py, seeded JAX variables
(``jax.eval_shape`` of ``init``, filled from numpy; no ``init`` is run),
one jitted JAX ``predict`` a detector, the port built through
``build_detector`` on the CPU and loaded through ``state_dict_from_jax``
with ``strict=True``, and the bar.

The bar, as tests/test_full_graph_parity.py sets it: identical detection
sets, labels and ``det_valid``, boxes and scores within 1e-4 (absolute,
pixels and probabilities on a 64x64 image; Grid R-CNN's voted boxes are
``det_bboxes``); mask logits and mask-IoU scores within ``LOGIT_TOL``. The
weights keep activations O(1), as a trained network's are (kernels
N(0, 1/fan_in), box regressors x0.1, classifiers x2, the last BN of each
residual branch x0.2): the two stacks then agree to <= 1.2e-5 on boxes and
<= 1.8e-6 on mask logits and scores of magnitude <= 1.35, summation order
through ~20 f32 layers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models import build_detector as _jax_registers  # noqa: F401
from vps_tpu.registry import DETECTORS as JDETECTORS

from test_cascade import stage_heads
from test_two_stage import IMG, TEST_CFG, tiny_cfg

from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import build_detector

BOX_TOL = 1e-4
# mask logits and mask-IoU scores: a few more conv / sigmoid layers on the
# pooled windows than the boxes; measured <= 1.8e-6 (values <= 1.35), held
# to the box bar
LOGIT_TOL = 1e-4

MASK = dict(
    mask_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                            featmap_strides=[4, 8, 16, 32]),
    mask_head=dict(num_convs=1, in_channels=32, conv_out_channels=32,
                   num_classes=5))


def fill(tree, rng, path=(), last_bn="bn2"):
    """Seeded values for an eval_shape tree, in sorted key order."""
    out = {}
    for k, v in sorted(tree.items()):
        p = path + (k,)
        if hasattr(v, "items"):
            if any(c.startswith("bn") for c in v):  # a residual block
                last_bn = "bn3" if "bn3" in v else "bn2"
            out[k] = fill(v, rng, p, last_bn)
            continue
        z = rng.standard_normal(tuple(v.shape), dtype=np.float32)
        name = "/".join(p)
        if k == "kernel":
            fan = int(np.prod(v.shape[:-1]))
            gain = (0.1 if "fc_reg" in name or "rpn_reg" in name
                    else 2.0 if "fc_cls" in name else 1.0)
            out[k] = z * np.float32(gain / np.sqrt(fan))
        elif k == "scale":
            last = (p[0].startswith(("backbone", "shared_head"))
                    and p[-2] == last_bn)
            out[k] = (1.0 + 0.1 * z) * (0.2 if last else 1.0)
        elif k == "var":
            out[k] = 1.0 + 0.1 * np.abs(z)
        elif k == "mean":
            out[k] = 0.1 * z
        else:  # bias
            out[k] = 0.02 * z
    return out


def mask_scoring_cfg(**over):
    return dict(mask_iou_head=dict(num_convs=2, num_fcs=1, roi_feat_size=14,
                                   in_channels=32, conv_out_channels=32,
                                   fc_out_channels=32, num_classes=5),
                **tiny_cfg(**MASK, **over))


def cascade_cfg(num_stages, mask=True):
    over = dict(MASK) if mask else {}
    return dict(num_stages=num_stages,
                **tiny_cfg(bbox_head=stage_heads()[:num_stages], **over))


def htc_cfg(semantic=True, mask_info_flow=True):
    cfg = dict(num_stages=2, interleaved=True, mask_info_flow=mask_info_flow,
               **tiny_cfg(bbox_head=stage_heads()[:2],
                          mask_roi_extractor=MASK["mask_roi_extractor"],
                          mask_head=dict(type="HTCMaskHead", num_convs=1,
                                         in_channels=32, conv_out_channels=32,
                                         num_classes=5)))
    if semantic:
        cfg.update(semantic_roi_extractor=dict(
            roi_layer=dict(out_size=14, sample_num=2), featmap_strides=[8]),
            semantic_head=dict(num_ins=5, fusion_level=1, num_convs=1,
                               in_channels=32, conv_out_channels=32,
                               num_classes=7))
    return cfg


def pair(kind, cfg, seed=0, test_cfg=TEST_CFG, img=IMG, proposals=None,
         port_kind=None):
    """vps_tpu's ``kind`` and the port's (``port_kind``, default the same
    name) on the same seeded weights and image. Returns (JAX outputs as
    numpy, the port's as numpy, the port detector)."""
    jdet = JDETECTORS.get(kind)(test_cfg=test_cfg, **cfg)
    extra = () if proposals is None else tuple(jnp.asarray(p) for p in proposals)
    shapes = jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), img, *extra, method=jdet.predict))
    rng = np.random.default_rng(seed)
    variables = {k: fill(v, rng) for k, v in shapes.items()}
    want = jax.jit(lambda v, *a: jdet.apply(v, img, *a, method=jdet.predict))(
        variables, *extra)
    port = build_detector(dict(cfg, type=port_kind or kind), test_cfg=test_cfg,
                          device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables.get("batch_stats")),
                         strict=True)
    args = () if proposals is None else tuple(torch.from_numpy(np.array(p))
                                               for p in proposals)
    got = port.predict(torch.from_numpy(np.array(img)), *args)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, port)


def assert_dets_match(want, got, box_tol=BOX_TOL, min_valid=3):
    """Identical detection sets, labels and validity; boxes and scores
    within ``box_tol``; every other float output within LOGIT_TOL."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    nvalid = int(want["det_valid"].sum())
    assert nvalid >= min_valid, f"too few detections ({nvalid})"
    np.testing.assert_array_equal(got["det_valid"], want["det_valid"])
    np.testing.assert_array_equal(got["det_labels"], want["det_labels"])
    np.testing.assert_allclose(got["det_bboxes"], want["det_bboxes"], rtol=0,
                               atol=box_tol)
    for k in set(want) - {"det_valid", "det_labels", "det_bboxes"}:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LOGIT_TOL,
                                   err_msg=k)
