"""Port parity, the zoo's training on HRNet: tests/test_two_stage.py's
HRNet -> HRFPN -> Faster R-CNN, one ``loss`` against vps_tpu's on the same
seeded weights, image, gt and sampler draws (``zoo_parity.train_pair``),
held by ``zoo_parity.assert_train_match``: every term, the sampled sets,
and the gradient of the total for every parameter, the fuse layers' among
them.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from backbone_parity import fill_backbone, hrnet_cfg
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TRAIN_CFG
from zoo_parity import assert_train_match, gt_sample, train_pair

BOX_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox")


def test_hrnet_faster_rcnn_loss_matches_jax():
    r = train_pair("FasterRCNN", hrnet_cfg(), TRAIN_CFG,
                   gt_sample(masks=False), fill_fn=fill_backbone)
    assert_train_match(r, BOX_KEYS)
    for name in ("backbone.stage4.0.fuse_layers.0.3.0.weight",
                 "backbone.stage4.0.fuse_layers.3.0.2.0.weight",
                 "backbone.transition3.3.0.0.weight",
                 "neck.reduction_conv.conv.weight"):
        assert r["tg"][name] is not None, name
