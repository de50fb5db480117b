"""Port parity, the R-CNN zoo's training: vps_torch's CascadeRCNN ``loss``
with 3 stages (IoU 0.5, 0.6, 0.7, stage weights 1, 0.5, 0.25, the stages'
shrinking target stds) and as Cascade Mask R-CNN with 2 stages, held
against vps_tpu's on tests/test_two_stage.py's tiny config, image and gt
and tests/test_cascade.py's train config, seeded weights, the same sampler
draws (``tests/zoo_parity.py``: ``train_pair`` and its bar). Each stage
samples the RoIs the stage before refined with its target labels'
detached deltas, the gt rows dropped.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_cascade import cascade_train_cfg
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import assert_train_match, cascade_cfg, gt_sample, train_pair


def stage_keys(n, mask):
    terms = ("loss_cls", "acc", "loss_bbox") + (("loss_mask",) if mask else ())
    return ("loss_rpn_cls", "loss_rpn_bbox") + tuple(
        f"s{i}.{t}" for i in range(n) for t in terms)


def test_cascade_rcnn_and_cascade_mask_rcnn_loss():
    r = train_pair("CascadeRCNN", cascade_cfg(3, mask=False),
                   cascade_train_cfg(), gt_sample(masks=False))
    assert_train_match(r, stage_keys(3, False), min_sampled=4)
    # a later stage's RoIs are the refined ones: no row of the gt block
    # (candidates 16..19) is valid in the RoIs the stage before refined
    assert all(r["jl"][f"s{i}.loss_cls"] > 0 for i in range(3))

    tc = dict(cascade_train_cfg(), rcnn=cascade_train_cfg()["rcnn"][:2],
              stage_loss_weights=[1.0, 0.5])
    r = train_pair("CascadeRCNN", cascade_cfg(2), tc, gt_sample(), seed=1)
    assert_train_match(r, stage_keys(2, True), min_sampled=3)
    assert r["tg"]["mask_head.1.conv_logits.weight"] is not None
