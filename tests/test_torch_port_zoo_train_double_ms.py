"""Port parity, the R-CNN zoo's training: vps_torch's DoubleHeadRCNN (the
reg branch on RoIs scaled by 1.3) and MaskScoringRCNN ``loss`` held
against vps_tpu's on tests/test_two_stage.py's tiny configs, TRAIN_CFG,
image and gt, seeded weights, the same sampler draws
(``tests/zoo_parity.py``: ``train_pair`` and its bar); and
``mask_iou_target`` alone, the port's against vps_tpu's, on boxes inside,
around, cutting and outside their gt masks.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.mask_heads import mask_iou_target as j_mask_iou_target

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TRAIN_CFG, tiny_cfg
from zoo_parity import (
    assert_train_match,
    gt_sample,
    mask_scoring_cfg,
    train_pair,
)

from vps_torch.models.mask_heads import mask_iou_target

BOX_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox")


def test_double_head_and_mask_scoring_loss_and_mask_iou_target():
    cfg = tiny_cfg(bbox_head=dict(
        type="DoubleConvFCBBoxHead", num_convs=1, num_fcs=1, in_channels=32,
        conv_out_channels=64, fc_out_channels=32, num_classes=5))
    r = train_pair("DoubleHeadRCNN", dict(cfg, reg_roi_scale_factor=1.3),
                   TRAIN_CFG, gt_sample(masks=False))
    assert_train_match(r, BOX_KEYS)
    assert r["tg"]["bbox_head.conv_branch.0.conv1.weight"] is not None

    r = train_pair("MaskScoringRCNN", mask_scoring_cfg(),
                   dict(TRAIN_CFG, rcnn=dict(TRAIN_CFG["rcnn"],
                                             mask_thr_binary=0.5)),
                   gt_sample(), seed=1)
    assert_train_match(r, BOX_KEYS + ("loss_mask", "loss_mask_iou"))
    assert r["jl"]["loss_mask_iou"] > 0
    assert r["tg"]["mask_iou_head.fc_mask_iou.weight"] is not None

    # the targets alone: a box holding its gt, one around it, one cutting
    # it in half, one outside it, one not valid; fractional corners
    rng = np.random.RandomState(4)
    masks = np.zeros((3, 40, 48), np.float32)
    masks[0, 5:25, 6:30] = 1
    masks[1, 10:38, 20:46] = 1
    masks[2, 0:12, 0:12] = 1
    rois = np.asarray([[6.0, 5.0, 29.0, 24.0], [2.3, 1.7, 33.9, 30.2],
                       [20.0, 10.0, 32.6, 37.0], [30.0, 0.0, 47.0, 8.0],
                       [0.0, 0.0, 11.0, 11.0]], np.float32)
    gt_idx = np.asarray([0, 0, 1, 2, 2], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0], bool)
    logits = rng.randn(5, 28, 28).astype(np.float32)
    targets = (rng.rand(5, 28, 28) > 0.4).astype(np.float32)
    want = jax.jit(j_mask_iou_target)(
        jnp.asarray(rois), jnp.asarray(gt_idx), jnp.asarray(valid),
        jnp.asarray(masks), jnp.asarray(logits), jnp.asarray(targets))
    got = mask_iou_target(*(torch.from_numpy(a) for a in (
        rois, gt_idx, valid, masks, logits, targets)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert got[4] == 0 and (got[:3] > 0).all()
