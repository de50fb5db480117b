"""Port parity, the R-CNN zoo's training: vps_torch's FastRCNN ``loss`` on
precomputed proposals (14 valid of 16) and the RPN detector's ``loss`` (the
anchor losses only, ``(img, gt_bboxes, gt_valid)``) held against vps_tpu's
on tests/test_two_stage.py's tiny configs, TRAIN_CFG, image and gt, seeded
weights, the same sampler draws (``tests/zoo_parity.py``: ``train_pair``
and its bar).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import TRAIN_CFG, tiny_cfg
from zoo_parity import assert_train_match, gt_sample, train_pair

PROPOSALS = np.asarray([[2.0, 2.0, 30.0, 32.0], [28.0, 6.0, 62.0, 42.0],
                        [8.0, 30.0, 44.0, 62.0], [0.0, 0.0, 16.0, 16.0]] * 4,
                       np.float32)


def test_fast_rcnn_and_rpn_loss():
    cfg = {k: v for k, v in tiny_cfg().items() if k != "rpn_head"}
    sample = dict(gt_sample(masks=False), proposals=PROPOSALS,
                  proposal_valid=np.arange(16) < 14)
    r = train_pair("FastRCNN", cfg, TRAIN_CFG, sample)
    assert r["port"].rpn_head is None
    assert_train_match(r, ("loss_cls", "acc", "loss_bbox"), min_sampled=1)
    # the two invalid proposals are never sampled
    inds, valid = r["tsel"][0]
    assert not np.isin(inds[valid], [14, 15]).any()

    base = tiny_cfg()
    sample = gt_sample(masks=False)
    sample.pop("gt_labels")
    r = train_pair("RPN", {k: base[k] for k in ("backbone", "neck",
                                               "rpn_head")},
                   dict(rpn=TRAIN_CFG["rpn"]), sample, seed=1)
    assert_train_match(r, ("loss_rpn_cls", "loss_rpn_bbox"), min_sampled=1)
    assert r["jl"]["loss_rpn_bbox"] > 0
