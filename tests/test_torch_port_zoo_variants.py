"""Port parity, the two-stage variants: vps_torch's DoubleHeadRCNN,
MaskScoringRCNN (on a caffe-style ResNet-50, as the published ms_rcnn
config has it: stride on the first 1x1 conv of a bottleneck), GridRCNN and
the C4 FasterRCNN (single-level extractor, the shared ResLayer, the
avg-pooled box head) held against vps_tpu's ``predict`` on
tests/test_two_stage.py's tiny configs and image, seeded weights
(``tests/zoo_parity.py``: its bar; Grid's voted boxes are ``det_bboxes``
and meet the box bar).

Double-Head's residual block keeps vps_tpu's bias on its 1x1 identity
projection (``bbox_head.res_block.conv_identity.conv.bias``), a divergence
from mmdet, whose projection feeds a BN and has none: a released mmdet
Double-Head checkpoint lacks that key, and would load with it set to 0.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TEST_CFG, tiny_cfg
from zoo_parity import assert_dets_match, mask_scoring_cfg, pair

from vps_torch.models.detectors import DoubleHeadRCNN, GridRCNN, MaskScoringRCNN


def test_double_head_mask_scoring_grid_and_c4():
    cfg = tiny_cfg(bbox_head=dict(
        type="DoubleConvFCBBoxHead", num_convs=1, num_fcs=1, in_channels=32,
        conv_out_channels=64, fc_out_channels=32, num_classes=5))
    want, got, port = pair("DoubleHeadRCNN", dict(cfg, reg_roi_scale_factor=1.3))
    assert type(port) is DoubleHeadRCNN and port.reg_roi_scale_factor == 1.3
    assert "bbox_head.res_block.conv_identity.conv.bias" in port.state_dict()
    assert_dets_match(want, got)

    caffe50 = dict(backbone=dict(type="ResNet", depth=50, frozen_stages=-1,
                                 out_indices=(0, 1, 2, 3), style="caffe"),
                   neck=dict(type="FPN", in_channels=(256, 512, 1024, 2048),
                             out_channels=32, num_outs=5))
    want, got, port = pair("MaskScoringRCNN", mask_scoring_cfg(**caffe50),
                           seed=1)
    assert type(port) is MaskScoringRCNN
    block = port.backbone.layer2[0]  # caffe: stride 2 on conv1, not conv2
    assert block.conv1.stride == (2, 2) and block.conv2.stride == (1, 1)
    assert got["mask_scores"].shape == (6,)
    assert_dets_match(want, got)

    cfg = dict(grid_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                                       featmap_strides=[4, 8, 16, 32]),
               grid_head=dict(grid_points=4, num_convs=2, roi_feat_size=14,
                              in_channels=32, point_feat_channels=8,
                              norm_groups=4),
               **tiny_cfg())
    want, got, port = pair("GridRCNN", cfg, seed=2)
    assert type(port) is GridRCNN
    assert_dets_match(want, got)
    valid = got["det_valid"]
    assert (got["det_bboxes"][valid, :4] >= 0).all()
    assert (got["det_bboxes"][valid, :4] <= 63).all()

    c4 = dict(backbone=dict(type="ResNet", depth=18, frozen_stages=-1,
                            out_indices=(2,), num_stages=3),
              neck=None,
              shared_head=dict(type="ResLayer", depth=18, stage=3, stride=2),
              rpn_head=dict(in_channels=256, feat_channels=32,
                            anchor_scales=[8], anchor_ratios=[0.5, 1.0, 2.0],
                            anchor_strides=[16]),
              bbox_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                                      featmap_strides=[16]),
              bbox_head=dict(num_classes=5, in_channels=512, num_fcs=0,
                             with_avg_pool=True, roi_feat_size=7))
    want, got, port = pair("FasterRCNN", c4, seed=3, test_cfg=TEST_CFG)
    assert port.neck is None and sum(
        k.startswith("shared_head.layer4.") for k in port.state_dict()) > 0
    assert_dets_match(want, got)
    assert np.isfinite(got["det_bboxes"]).all()
