"""The frozen reference (``reference/vpsref``) computes what the program
computes, at a tiny size on the CPU, from the benchmark's own weights and
inputs: the video path frame for frame (and, replayed on the program's
detections, its tracks and fusion), Mask R-CNN's detections, and a
training step's loss terms and gradients, exactly."""

import numpy as np
import torch

import tiny
import traffic
import weights
from reference import drive


def test_video_frames_equal():
    from vps_torch.models.detectors import (build_detector,
                                            empty_track_state,
                                            predict_video)
    cell = tiny.cell("fusetrack_cs.video")
    cfg, t = cell["config_file"], cell["traffic"]
    frames = traffic.videos(t, 5, "cpu")[0][:3]
    det = build_detector(cfg["model"], test_cfg=cfg["test_cfg"], device="cpu")
    weights.fill(det, 5, "cpu")
    imgs = torch.as_tensor(frames)
    out, _ = predict_video(det, imgs, [True, False, False],
                           empty_track_state(256, device="cpu"), imgs[0])
    prog = [{k: v[i].numpy() for k, v in out.items()} for i in range(3)]
    ref, rep, _ = drive.video(cfg, 5, frames, "cpu", replay=prog)
    for side in (ref, rep):
        for i in range(3):
            for k, v in prog[i].items():
                np.testing.assert_array_equal(v, side[i][k], err_msg=k)


def test_mask_rcnn_detections_equal():
    from vps_torch.models.detectors import build_detector
    from vps_torch.ops.mask import paste_masks
    cell = tiny.cell("mask_rcnn_coco.images")
    cfg, t = cell["config_file"], cell["traffic"]
    imgs = traffic.images(t, 6, "cpu")[:2]
    det = build_detector(cfg["model"], test_cfg=cfg["test_cfg"], device="cpu")
    weights.fill(det, 6, "cpu")
    hw = (t["height"], t["width"])
    ref, _ = drive.images(cfg, 6, imgs, hw, "cpu")
    for img, (boxes, labels, masks) in zip(imgs, ref):
        out = det.predict(torch.as_tensor(img))
        v = out["det_valid"]
        np.testing.assert_array_equal(out["det_bboxes"][v].numpy(), boxes)
        np.testing.assert_array_equal(out["det_labels"][v].numpy(), labels)
        pasted = paste_masks(torch.sigmoid(out["mask_logits"][v]),
                             out["det_bboxes"][v, :4], hw, binarize=0.5) > 0.5
        np.testing.assert_array_equal(pasted.numpy(), masks)


def test_train_steps_equal():
    from vps_torch.models.detectors import build_detector
    from vps_torch.train.optim import build_lr_schedule, build_optimizer
    from vps_torch.train.step import TrainState, make_train_step
    from vps_torch.utils.numerics import train_policy
    cell = tiny.cell("fusetrack_cs.train")
    cfg, t = cell["config_file"], cell["traffic"]
    batches = traffic.train_batches(t, 7, "cpu")
    det = build_detector(cfg["train_model"], train_cfg=cfg["train_cfg"],
                         test_cfg=cfg["test_cfg"], device="cpu")
    weights.fill(det, 7, "cpu")
    opt, _ = build_optimizer(det, build_lr_schedule(
        t["lr"], t["steps_per_epoch"], t["epochs"]), momentum=t["momentum"],
        weight_decay=t["weight_decay"], grad_clip=t["grad_clip"])
    p0 = [p.detach().clone() for p in opt.params]
    step, state = make_train_step(det, opt), TrainState(opt, 0)
    gen = torch.Generator().manual_seed(123)
    losses = []
    with train_policy():  # as the harness runs the program
        for i in range(3):
            state, logs = step(state, batches[i], gen)
            losses.append(float(logs["loss"]))
    ref, _ = drive.train(cfg, t, 7, batches, 123, "cpu")
    assert losses == ref["loss"]
    change = {n: float((p.detach() - q).norm())
              for n, p, q in zip(opt.names, opt.params, p0)}
    assert change == ref["change"]
