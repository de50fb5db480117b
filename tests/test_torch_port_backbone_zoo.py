"""Port parity, the zoo's detectors on the new backbones: Faster R-CNN on
tests/test_two_stage.py's tiny HRNet and HRFPN, and a tiny Mask R-CNN on
an R-50 with DCN, ContextBlocks and the empirical attention
(``backbone_parity.plugins_cfg``), against vps_tpu's ``predict`` on the
same seeded weights (non-zero ``gamma`` and ContextBlock weights) and
image: ``zoo_parity.assert_dets_match``, identical detection sets, boxes
and scores within 1e-4.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from backbone_parity import fill_backbone, hrnet_cfg, plugins_cfg
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import assert_dets_match, pair


def test_hrnet_faster_and_plugins_mask_rcnn_match_jax():
    want, got, port = pair("FasterRCNN", hrnet_cfg(), fill_fn=fill_backbone)
    assert type(port.backbone).__name__ == "HRNet"
    assert_dets_match(want, got)
    want, got, port = pair("MaskRCNN", plugins_cfg(), seed=1,
                           fill_fn=fill_backbone)
    gammas = [float(b.gen_attention_block.gamma.detach())
              for b in port.backbone.layer3]
    assert min(abs(g) for g in gammas) > 0.1, gammas
    assert_dets_match(want, got)
