"""Port parity, the R-CNN zoo's training: vps_torch's FasterRCNN and
MaskRCNN ``loss`` held against vps_tpu's on tests/test_two_stage.py's tiny
configs, TRAIN_CFG, image and gt, seeded weights, the same sampler draws
(``tests/zoo_parity.py``: ``train_pair`` and its bar: every term, the
sampled sets, the gradient of the total for every parameter); and the
frozen parts of a published config (``frozen_stages=1``, FrozenBatchNorm):
in train mode a step changes no running statistic and gives the stem and
stage 1 no gradient.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

import numpy as np
import torch

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_two_stage import IMG, TEST_CFG, TRAIN_CFG, tiny_cfg
from zoo_parity import MASK, assert_train_match, gt_sample, train_pair

from vps_torch.models.detectors import FasterRCNN, MaskRCNN, build_detector
from vps_torch.train.optim import build_optimizer

RPN_KEYS = ("loss_rpn_cls", "loss_rpn_bbox")
BOX_KEYS = RPN_KEYS + ("loss_cls", "acc", "loss_bbox")


def test_faster_and_mask_rcnn_loss_and_frozen_parts():
    r = train_pair("FasterRCNN", tiny_cfg(), TRAIN_CFG,
                   gt_sample(masks=False))
    assert type(r["port"]) is FasterRCNN
    assert_train_match(r, BOX_KEYS)
    assert r["jl"]["loss_cls"] > 0 and r["jl"]["loss_bbox"] > 0

    r = train_pair("MaskRCNN", tiny_cfg(**MASK), TRAIN_CFG, gt_sample(),
                   seed=1)
    assert type(r["port"]) is MaskRCNN
    assert_train_match(r, BOX_KEYS + ("loss_mask",))
    assert r["jl"]["loss_mask"] > 0
    assert r["tg"]["mask_head.conv_logits.weight"] is not None

    # frozen_stages=1 with FrozenBatchNorm, as the published configs train
    cfg = tiny_cfg(**MASK)
    cfg["backbone"] = dict(cfg["backbone"], frozen_stages=1)
    det = build_detector(dict(cfg, type="MaskRCNN"), train_cfg=TRAIN_CFG,
                         test_cfg=TEST_CFG, device="cpu").train()
    frozen = {n for n, p in det.named_parameters() if not p.requires_grad}
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.bn1",
                                        "backbone.layer1."))
                          for n in frozen)
    assert any(n.startswith("backbone.layer1.") for n in frozen)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    opt, _ = build_optimizer(det, lambda step: np.float32(0.02))
    losses = det.loss(torch.from_numpy(np.asarray(IMG)),
                      **{k: torch.from_numpy(v)
                         for k, v in gt_sample().items()},
                      generator=torch.Generator().manual_seed(0))
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert all(p.grad is None for n, p in det.named_parameters()
               if n in frozen)
    opt.step()
    after = det.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(after[k], before[k]) for k in stats)
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    moved = [n for n, p in det.named_parameters()
             if p.requires_grad and not torch.equal(after[n], before[n])]
    assert "backbone.layer2.0.conv1.weight" in moved
