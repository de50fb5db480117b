"""Port parity, the zoo's training on the new backbones: the Mask R-CNN of
tests/test_torch_port_backbone_zoo.py on an R-50 with DCN, ContextBlocks
and the attention (stage 1 frozen), one ``loss`` against vps_tpu's on the
same seeded weights, image, gt and sampler draws
(``zoo_parity.train_pair``), held by ``zoo_parity.assert_train_match``:
every term, the sampled sets, and the gradient of the total for every
parameter, the DCN offset convs, the attention's ``gamma`` and the
ContextBlocks' among them. HRNet's Faster R-CNN is
``test_torch_port_backbone_zoo_train_hrnet.py``'s.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np

from backbone_parity import fill_backbone, plugins_cfg
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TRAIN_CFG
from zoo_parity import assert_train_match, gt_sample, train_pair

BOX_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox")


def test_plugins_mask_rcnn_loss_matches_jax():
    r = train_pair("MaskRCNN", plugins_cfg(), TRAIN_CFG, gt_sample(), seed=1,
                   fill_fn=fill_backbone)
    assert_train_match(r, BOX_KEYS + ("loss_mask",))
    tg = r["tg"]
    for name in ("backbone.layer2.0.conv2_offset.weight",
                 "backbone.layer2.0.conv2.weight",
                 "backbone.layer3.0.gen_attention_block.gamma",
                 "backbone.layer4.2.context_block.channel_add_conv.3.weight",
                 "backbone.layer4.2.context_block.conv_mask.weight"):
        assert tg[name] is not None and np.abs(tg[name]).max() > 0, name
    assert tg["backbone.layer1.0.conv2.weight"] is None  # frozen stage 1
