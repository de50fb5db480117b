"""Port parity, the R-CNN zoo's training: vps_torch's HybridTaskCascade
``loss`` (2 stages, interleaved: refine and sample again before each
stage's mask branch, two draws a stage; the mask information flow; the
fused semantic head's loss on stride-8 labels with 255 ignored) and the
``HTC`` alias without the semantic head or the flow, not interleaved, held
against vps_tpu's on tests/test_two_stage.py's tiny config, image and gt
and tests/test_cascade.py's train config, seeded weights, the same sampler
draws (``tests/zoo_parity.py``: ``train_pair`` and its bar).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_cascade import cascade_train_cfg
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_torch_port_zoo_train_cascade import stage_keys
from zoo_parity import assert_train_match, gt_sample, htc_cfg, train_pair

from vps_torch.models.detectors import HybridTaskCascade


def test_htc_and_alias_loss():
    tc = dict(cascade_train_cfg(), rcnn=cascade_train_cfg()["rcnn"][:2],
              stage_loss_weights=[1.0, 0.5])
    r = train_pair("HybridTaskCascade", htc_cfg(), tc,
                   gt_sample(semantic=True))
    # the RPN's draw, then two a stage
    assert_train_match(r, stage_keys(2, True) + ("loss_semantic_seg",),
                       min_sampled=5)
    assert len(r["tsel"]) == 5
    assert r["tg"]["semantic_head.conv_logits.weight"] is not None
    assert r["tg"]["mask_head.1.conv_res.conv.weight"] is not None

    cfg = dict(htc_cfg(semantic=False, mask_info_flow=False),
               interleaved=False)
    r = train_pair("HybridTaskCascade", cfg, tc, gt_sample(), seed=1,
                   port_kind="HTC")
    assert type(r["port"]) is HybridTaskCascade
    assert_train_match(r, stage_keys(2, True), min_sampled=3)
    assert len(r["tsel"]) == 3
