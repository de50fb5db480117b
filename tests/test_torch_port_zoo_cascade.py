"""Port parity, Cascade R-CNN: vps_torch's CascadeRCNN held against
vps_tpu's ``predict`` with 3 stages (the stages' shrinking target stds of
tests/test_cascade.py, no mask head) and as Cascade Mask R-CNN with 2
stages (one mask head config, each stage its own parameters; the masks the
logit of the mean of the stages' sigmoids), on tests/test_two_stage.py's
tiny config and image, seeded weights (``tests/zoo_parity.py``: its bar).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import assert_dets_match, cascade_cfg, pair

from vps_torch.models.detectors import CascadeRCNN


def test_cascade_rcnn_and_cascade_mask_rcnn():
    want, got, port = pair("CascadeRCNN", cascade_cfg(3, mask=False))
    assert type(port) is CascadeRCNN and len(port.bbox_head) == 3
    assert [h.target_stds for h in port.bbox_head] == [
        (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067)]
    assert port.mask_head is None and "mask_logits" not in got
    assert_dets_match(want, got)

    want, got, port = pair("CascadeRCNN", cascade_cfg(2), seed=1)
    assert len(port.mask_head) == 2
    assert got["mask_logits"].shape == (6, 28, 28)
    assert_dets_match(want, got)
