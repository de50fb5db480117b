"""The program's entries that a cell drives, one class each, chosen by the
``entry`` of the cell's workload file.

Each builds the program's object in ``setup`` (seeded weights made on the
card, the inputs from the traffic file, every shape warmed), runs it for
the window in ``window``, frees it in ``release``, and in ``check`` hands
what the timed path produced, with the same inputs, to the plain reference
(``reference/``) and returns the numbers that decide ``correct``.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

import traffic
import weights


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """What a window did: units done (frames, steps, images), attempted
    and failed, its seconds (from its start to its last unit's end), and
    each unit's latency in seconds where the entry has one."""

    def __init__(self):
        self.units = self.attempted = self.failed = 0
        self.seconds = 0.0
        self.latencies = []


class Entry:
    def __init__(self, cell, cfg, seed, device, control=None):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.t = cell["traffic"]
        self.device = torch.device(device)
        self.control = control
        self.policy = contextlib.ExitStack()
        self.rng = random.Random(int(seed) ^ 0x5EED)

    def close(self):
        self.policy.close()


class Video(Entry):
    """``run_video_streams``: whole videos round-robin over the streams,
    ``chunk`` frames a ``predict_video`` call, in a closed loop (the
    program takes the next chunk when a stream is free)."""

    def setup(self):
        from vps_torch.models.detectors import build_detector, run_video_streams
        from vps_torch.utils.numerics import inference_policy

        self.policy.enter_context(inference_policy())
        self.det = build_detector(self.cfg["model"],
                                  test_cfg=self.cfg["test_cfg"],
                                  device=self.device)
        weights.fill(self.det, self.seed, self.device)
        self.videos = traffic.videos(self.t, self.seed, self.device)
        self.run = run_video_streams
        # every shape: a reset frame and a carried one, on each stream
        warm = [(v[i], i == 0, None) for v in self.videos[:2] for i in range(2)]
        self.run(self.det, warm, 2, lambda o, m: None,
                 n_streams=self.t["streams"])
        _sync(self.device)

    def window(self, seconds):
        w = Window()
        n, chunk = self.t["frames"], self.t["chunk"]
        done = {}  # pass -> {frame: outputs}
        t0 = time.perf_counter()
        end = t0 + seconds

        def frames():
            k = 0
            while True:
                vid = self.videos[k % len(self.videos)]
                for i in range(n):
                    if i % chunk == 0 and time.perf_counter() >= end:
                        return
                    w.attempted += 1
                    yield vid[i], i == 0, (k, i)
                k += 1

        last = [t0]

        def record(outputs, meta):
            last[0] = time.perf_counter()
            done.setdefault(meta[0], {})[meta[1]] = {
                k: np.asarray(v) for k, v in outputs.items()}

        self.run(self.det, frames(), chunk, record,
                 n_streams=self.t["streams"])
        w.seconds = last[0] - t0
        w.units = sum(len(v) for v in done.values())
        w.failed = w.attempted - w.units
        whole = sorted(k for k, v in done.items() if len(v) == n)
        self.sample = self.rng.choice(whole) if whole else None
        self.outputs = ([done[self.sample][i] for i in range(n)]
                        if whole else None)
        return w

    def release(self):
        del self.det
        _sync(self.device)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, counter=None):
        from reference import drive, judge

        if self.outputs is None:
            return {"whole_videos": 0.0}, None
        frames = self.videos[self.sample % len(self.videos)]
        ref, rep, flops = drive.video(
            self.cfg, self.seed, frames, self.device, counter=counter,
            corr_dtype=self.cell["correlation_dtype"], replay=self.outputs)
        pan = self.cfg["model"]["panoptic"]
        num_stuff = pan["num_classes"] - pan["num_things_classes"]
        nums = judge.video(self.outputs, ref, rep, num_stuff)
        if self.control:
            ctl, _, _ = drive.video(self.cfg, self.seed, frames, self.device,
                                    control=self.control)
            _, ctl_rep, _ = drive.video(self.cfg, self.seed, frames,
                                        self.device, replay=ctl)
            nums.update({f"control.{k}": v for k, v in
                         judge.video(ctl, ref, ctl_rep, num_stuff).items()})
        if flops is not None:
            flops = {k: v / len(frames) for k, v in flops.items()}
        return nums, flops


class Train(Entry):
    """``make_train_step``: one step a call, forward, backward and the
    optimizer, each step's batch uploaded from the host and the step ended
    by a synchronize. Set-up drives the same step object through its first
    three steps, which the reference follows."""

    def setup(self):
        from vps_torch.models.detectors import build_detector
        from vps_torch.train.optim import build_lr_schedule, build_optimizer
        from vps_torch.train.step import TrainState, make_train_step
        from vps_torch.utils.numerics import train_policy

        t = self.t
        self.policy.enter_context(train_policy())
        det = build_detector(self.cfg["train_model"],
                             train_cfg=self.cfg["train_cfg"],
                             test_cfg=self.cfg["test_cfg"], device=self.device)
        weights.fill(det, self.seed, self.device)
        schedule = build_lr_schedule(t["lr"], t["steps_per_epoch"],
                                     t["epochs"])
        opt, _ = build_optimizer(det, schedule, momentum=t["momentum"],
                                 weight_decay=t["weight_decay"],
                                 grad_clip=t["grad_clip"])
        self.det, self.opt = det, opt
        self.step = make_train_step(det, opt)
        self.state = TrainState(opt, 0)
        self.batches = traffic.train_batches(t, self.seed, self.device)
        self.gen_seed = (int(self.seed) * 7919 + 17) % 2 ** 63
        self.gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        p0 = [p.detach().clone() for p in opt.params]
        losses, terms, grad = [], [], None
        for i in range(3):  # the first three steps: warm-up and the check's
            self._one(i)
            losses.append(float(self.logs["loss"]))
            terms.append({k: float(v) for k, v in self.logs.items()
                          if "loss" in k})
            if i == 0:
                grad = {n: float((tr - opt.weight_decay * p).norm())
                        for n, tr, p in zip(opt.names, opt.trace, p0)}
        change = {n: float((p.detach() - q).norm())
                  for n, p, q in zip(opt.names, opt.params, p0)}
        del p0
        self.first = {"loss": losses, "terms": terms, "grad": grad,
                      "change": change}
        self.k = 3

    def _one(self, i):
        batch = traffic.upload(self.batches[i % len(self.batches)],
                               self.device)
        self.state, self.logs = self.step(self.state, batch, self.gen)
        _sync(self.device)

    def window(self, seconds):
        w = Window()
        skips = self.opt.total_notfinite
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            w.attempted += 1
            self._one(self.k)
            self.k += 1
        w.seconds = time.perf_counter() - t0
        w.failed = self.opt.total_notfinite - skips
        w.units = w.attempted
        return w

    def release(self):
        del self.det, self.opt, self.step, self.state, self.logs
        _sync(self.device)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, counter=None):
        from reference import drive, judge

        ref, flops = drive.train(self.cfg, self.t, self.seed, self.batches,
                                 self.gen_seed, self.device, counter=counter)
        nums = judge.train(self.first, ref)
        if self.control:
            ctl, _ = drive.train(self.cfg, self.t, self.seed, self.batches,
                                 self.gen_seed, self.device,
                                 control=self.control)
            nums.update({f"control.{k}": v for k, v in
                         judge.train(ctl, ref).items()})
        if flops is not None:
            flops = {k: v / 3 for k, v in flops.items()}
        return nums, flops


class Images(Entry):
    """``predict`` on one image at a time from one client in a closed
    loop: the image uploaded, predicted, its masks pasted at the image's
    size and binarised, its boxes, scores, labels and masks brought to the
    host. Every ``check_every``-th request from a seeded first one keeps its
    outputs for the check."""

    def setup(self):
        from vps_torch.models.detectors import build_detector
        from vps_torch.ops.mask import paste_masks
        from vps_torch.utils.numerics import inference_policy

        self.policy.enter_context(inference_policy())
        self.det = build_detector(self.cfg["model"],
                                  test_cfg=self.cfg["test_cfg"],
                                  device=self.device)
        weights.fill(self.det, self.seed, self.device)
        self.paste = paste_masks
        self.imgs = traffic.images(self.t, self.seed, self.device)
        self.hw = (self.t["height"], self.t["width"])
        self.thr = self.cfg["test_cfg"]["rcnn"]["mask_thr_binary"]
        self._request(0)
        _sync(self.device)

    def _request(self, i):
        img = torch.as_tensor(self.imgs[i % len(self.imgs)],
                              device=self.device)
        out = self.det.predict(img)
        valid = out["det_valid"]
        boxes = out["det_bboxes"][valid]
        masks = self.paste(torch.sigmoid(out["mask_logits"][valid]),
                           boxes[:, :4], self.hw, binarize=self.thr) > 0.5
        return (boxes.cpu().numpy(), out["det_labels"][valid].cpu().numpy(),
                masks.cpu().numpy())

    def window(self, seconds):
        w = Window()
        kept, every, cap = [], self.t["check_every"], self.t["check_images"]
        first = self.rng.randrange(every)
        t0 = time.perf_counter()
        end, now = t0 + seconds, t0
        i = 0
        while now < end:
            w.attempted += 1
            res = self._request(i)
            t1 = time.perf_counter()
            w.latencies.append(t1 - now)
            now = t1
            if i % every == first and len(kept) < cap:
                kept.append((i % len(self.imgs), res))
            i += 1
        w.units = w.attempted
        w.seconds = now - t0
        self.kept = kept
        return w

    def release(self):
        del self.det
        _sync(self.device)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, counter=None):
        from reference import drive, judge

        if not self.kept:
            return {"checked_images": 0.0}, None
        imgs = [self.imgs[i] for i, _ in self.kept]
        prog = [r for _, r in self.kept]
        ref, flops = drive.images(self.cfg, self.seed, imgs, self.hw,
                                  self.device, counter=counter)
        nums = judge.images(prog, ref)
        if self.control:
            ctl, _ = drive.images(self.cfg, self.seed, imgs, self.hw,
                                  self.device, control=self.control)
            nums.update({f"control.{k}": v for k, v in
                         judge.images(ctl, ref).items()})
        if flops is not None:
            flops = {k: v / len(imgs) for k, v in flops.items()}
        return nums, flops


ENTRIES = {"video": Video, "train": Train, "images": Images}
