"""The plain reference driven over the inputs a run checks.

The reference is ``reference.vpsref``: a frozen copy of the port's plain
PyTorch modules, with every hand-written kernel replaced by its plain
version (correlation, deformable conv). It imports nothing of the program.
It builds its own detector from the configuration, fills it with the
benchmark's seeded weights, and works out again from the benchmark's inputs
what the program's timed path produced. Each function runs at the precision
the configuration states, with TF32 off, unless ``control`` names the lower
precision of the control (``control.py``).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

import weights
from reference import control as lower
from reference.vpsref.models.detectors import (build_detector,
                                               empty_track_state,
                                               predict_video)
from reference.vpsref.models.detectors.panoptic_ops import \
    mask_removal_and_fuse
from reference.vpsref.ops.mask import paste_masks
from reference.vpsref.train.optim import build_lr_schedule, build_optimizer
from reference.vpsref.train.step import TrainState, make_train_step

corr_mod = importlib.import_module("reference.vpsref.ops.correlation")


@contextlib.contextmanager
def _flags(train=False):
    """TF32 off, cuDNN deterministic without the benchmark search, and for
    training the deterministic algorithms; the old values back on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if train:
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old[:4]
        torch.use_deterministic_algorithms(old[4])


def _counted(counter, det):
    """``counter`` (a ``flops.Counter`` class) opened over ``det``, or a
    null context."""
    if counter is None:
        return contextlib.nullcontext(None)
    return counter(det)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def detector(cfg, seed, device, train=False):
    model = cfg["train_model"] if train else cfg["model"]
    det = build_detector(model, train_cfg=cfg.get("train_cfg") if train
                         else None, test_cfg=cfg["test_cfg"], device=device)
    weights.fill(det, seed, device)
    return det


class _Replay:
    """The reference's track head, track memory, mask head and panoptic
    fusion run on the program's detections of each frame (its boxes,
    probabilities, labels and validity, as the program output them), on
    the reference's own features and semantic logits of that frame. While
    open, every ``predict`` of ``det`` is followed by this step, its FLOPs
    left out of ``count``; ``outputs`` holds each frame's outputs as numpy
    dicts. The detections are the only thing taken from the program. One
    video a replay, its first frame a reset: the memory starts empty."""

    def __init__(self, det, prog, device, count=None):
        self.det, self.prog, self.device, self.count = det, prog, device, count
        self.state = empty_track_state(256, device=device)
        self.outputs, self._feats = [], {}

    def __enter__(self):
        det, feats = self.det, self._feats
        cls = type(det)

        def fused(*args, **kw):
            out = cls._fused_feats(det, *args, **kw)
            feats["x"] = out[0]
            return out

        def predict(img, ref_img, state, **kw):
            out = cls.predict(det, img, ref_img, state, **kw)
            with (self.count.paused() if self.count is not None
                  else contextlib.nullcontext()):
                self._frame()
            return out

        self._hook = det.panopticFPN.register_forward_hook(
            lambda m, i, o: feats.__setitem__("fcn", o[0]))
        det._fused_feats, det.predict = fused, predict
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        del self.det._fused_feats, self.det.predict
        self._feats.clear()

    @torch.no_grad()
    def _frame(self):
        det, dev = self.det, self.device
        p = self.prog[len(self.outputs)]
        boxes = torch.as_tensor(p["det_bboxes"], device=dev)
        probs = torch.as_tensor(p["det_probs"], device=dev)
        labels = torch.as_tensor(p["det_labels"], device=dev).long()
        valid = torch.as_tensor(p["det_valid"], device=dev).bool()
        det_cls = torch.where(valid, labels + 1, torch.zeros_like(labels))
        x = self._feats["x"]
        ids, self.state = det._track(x, boxes, probs, labels, valid,
                                     self.state)
        masks = det._mask_scores(x, boxes, det_cls, valid)
        fusion = mask_removal_and_fuse(
            boxes, probs, det_cls, valid, ids, masks, self._feats["fcn"][0],
            num_stuff=det.panopticFPN.num_stuff_classes)
        out = det._outputs(fusion, boxes, labels, probs, valid, None)
        self.outputs.append({k: v.cpu().numpy() for k, v in out.items()})


def video(cfg, seed, frames, device, control=None, counter=None,
          corr_dtype="bfloat16", replay=None):
    """``predict_video`` over one whole video (frames (T, 1, H, W, 3) host
    float32, the first a reset), chunk by chunk as the program's streams
    run it. With ``replay`` (the program's outputs of those frames), each
    frame is followed by ``_Replay``'s step on the program's detections.
    Returns (the frames' outputs as numpy dicts, the replay's outputs or
    None, FLOPs by bucket or None)."""
    det = detector(cfg, seed, device)
    out, chunk = [], 8
    with _flags(), lower.context(control), corr_mod.record_calls() as calls, \
            _counted(counter, det) as count:
        rep = (_Replay(det, replay, device, count) if replay is not None
               else contextlib.nullcontext())
        with rep:
            state = empty_track_state(256, device=device)
            prev = feats = None
            for lo in range(0, len(frames), chunk):
                imgs = torch.as_tensor(frames[lo:lo + chunk], device=device)
                resets = [lo + i == 0 for i in range(len(imgs))]
                if prev is None:
                    prev = imgs[0]
                res, (state, feats, prev) = predict_video(
                    det, imgs, resets, state, prev, prev_feats=feats)
                for t in range(len(imgs)):
                    out.append({k: v[t].cpu().numpy() for k, v in res.items()})
        _sync(device)
    return (out, rep.outputs if replay is not None else None,
            _finish_count(count, calls, (), corr_dtype))


def _finish_count(count, calls, differentiated, corr_dtype="float32"):
    """The counter's FLOPs with the correlations' added from the recorded
    calls, in the precision the configuration sets for them."""
    if count is None:
        return None
    count.close()
    from flops import correlation_flops
    f = dict(count.flops)
    for shape, md, s2 in calls:
        f[corr_dtype] += correlation_flops(shape, md, s2)
        if [md, s2] in differentiated:
            f[corr_dtype] += correlation_flops(shape, md, s2, backward=True)
    return f


def images(cfg, seed, imgs, hw, device, control=None, counter=None):
    """``predict`` and the paste of each image (imgs: (N, 1, PH, PW, 3)
    host float32) as the program's requests run them: [(boxes with scores
    (n, 5), labels (n,), masks (n, H, W) bool)] of the valid detections."""
    det = detector(cfg, seed, device)
    thr = cfg["test_cfg"]["rcnn"]["mask_thr_binary"]
    out = []
    with _flags(), lower.context(control), _counted(counter, det) as count:
        for img in imgs:
            res = det.predict(torch.as_tensor(img, device=device))
            valid = res["det_valid"]
            boxes = res["det_bboxes"][valid]
            masks = paste_masks(torch.sigmoid(res["mask_logits"][valid]),
                                boxes[:, :4], tuple(hw), binarize=thr) > 0.5
            out.append((boxes.cpu().numpy(), res["det_labels"][valid].cpu()
                        .numpy(), masks.cpu().numpy()))
        _sync(device)
    return out, _finish_count(count, (), ())


def train(cfg, t, seed, batches, gen_seed, device, control=None,
          counter=None):
    """Three steps of ``make_train_step`` from the seeded weights on the
    first three batches (host dicts), the generator seeded as the
    program's. Returns ({"loss": [3 totals], "grad": {leaf: norm of the
    first step's clipped gradient}, "change": {leaf: norm of the
    parameters' change after three steps}}, FLOPs by bucket or None)."""
    det = detector(cfg, seed, device, train=True)
    schedule = build_lr_schedule(t["lr"], t["steps_per_epoch"], t["epochs"])
    opt, _ = build_optimizer(det, schedule, momentum=t["momentum"],
                             weight_decay=t["weight_decay"],
                             grad_clip=t["grad_clip"])
    step = make_train_step(det, opt)
    state = TrainState(opt, 0)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    p0 = [p.detach().clone() for p in opt.params]
    losses, terms, grad = [], [], None
    with _flags(train=True), lower.context(control), \
            corr_mod.record_calls() as calls, _counted(counter, det) as count:
        for i in range(3):
            batch = {k: v.to(device) for k, v in batches[i].items()}
            state, logs = step(state, batch, gen)
            losses.append(float(logs["loss"]))
            terms.append({k: float(v) for k, v in logs.items()
                          if "loss" in k})
            if i == 0:
                grad = {n: float((tr - opt.weight_decay * p).norm())
                        for n, tr, p in zip(opt.names, opt.trace, p0)}
        _sync(device)
    change = {n: float((p.detach() - q).norm())
              for n, p, q in zip(opt.names, opt.params, p0)}
    flops = _finish_count(count, calls, t.get("differentiated_correlations",
                                              ()))
    return {"loss": losses, "terms": terms, "grad": grad,
            "change": change}, flops


