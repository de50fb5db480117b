"""Port parity, the R-CNN zoo's training: vps_torch's GridRCNN ``loss``
(the positives jittered by one (n, 4) draw, the grid head's fused and
unfused heatmaps, weight 15) held against vps_tpu's on
tests/test_two_stage.py's tiny configs, TRAIN_CFG, image and gt, seeded
weights, the same sampler draws and jitter (``tests/zoo_parity.py``:
``train_pair`` and its bar); and ``grid_target`` alone, the port's against
vps_tpu's, for 4 and 9 grid points.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.mask_heads import grid_target as j_grid_target

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TRAIN_CFG, tiny_cfg
from zoo_parity import assert_train_match, gt_sample, train_pair

from vps_torch.models.mask_heads import grid_target

GRID = dict(
    grid_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                            featmap_strides=[4, 8, 16, 32]),
    grid_head=dict(grid_points=4, num_convs=2, roi_feat_size=14,
                   in_channels=32, point_feat_channels=8, norm_groups=4))


def test_grid_rcnn_loss_and_grid_target():
    # TRAIN_CFG's rcnn samples 16 at 0.25: 4 positive slots, one jitter row
    # each, at the extremes of [-0.15, 0.15) too
    jitter = np.random.RandomState(3).uniform(-0.15, 0.15, (4, 4))
    jitter[0] = [-0.15, 0.1499, -0.15, 0.1499]
    r = train_pair("GridRCNN", dict(GRID, **tiny_cfg()),
                   dict(TRAIN_CFG, rcnn=dict(TRAIN_CFG["rcnn"], pos_radius=1,
                                             max_num_grid=192)),
                   gt_sample(masks=False), jitter=jitter.astype(np.float32))
    assert_train_match(r, ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                           "acc", "loss_bbox", "loss_grid"))
    assert r["jl"]["loss_grid"] > 0
    assert r["tg"]["grid_head.deconv1.weight"] is not None

    # the targets alone: random boxes, one too small for the grid, one not
    # valid, gt boxes around them
    rng = np.random.RandomState(6)
    xy = rng.uniform(0, 40, (12, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 30, (12, 2))], 1)
    rois[3, 2:] = rois[3, :2] + 1.0
    gts = rois + rng.uniform(-6, 6, (12, 4))
    valid = np.ones(12, bool)
    valid[5] = False
    for points, radius in ((4, 1), (9, 1), (9, 2)):
        args = (rois.astype(np.float32), gts.astype(np.float32), valid)
        want = jax.jit(lambda a, b, c: j_grid_target(
            a, b, c, grid_points=points, roi_feat_size=14,
            pos_radius=radius))(*(jnp.asarray(a) for a in args))
        got = grid_target(*(torch.from_numpy(a) for a in args),
                          grid_points=points, roi_feat_size=14,
                          pos_radius=radius)
        assert got.shape == (12, 28, 28, points)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[[3, 5]].sum() == 0 and got.sum() > 0
