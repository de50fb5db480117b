"""Epoch-based training runner (port of vps_tpu/train/runner.py): the LR
schedule, text logging, checkpoints, ``load_from`` / ``resume_from`` and a
post-epoch ``eval_fn`` hook, over any loader with ``epoch(e)`` (an iterable
of batches: dicts of arrays with a leading batch dim) and
``steps_per_epoch()``.

``run`` trains under ``vps_torch.utils.numerics.train_policy``: a step
repeats bit for bit from the same weights, optimizer state and generator,
as the JAX trainer's does.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
import time
from typing import Any, Dict, List, Optional

import torch

from vps_torch.train.optim import build_lr_schedule, build_optimizer
from vps_torch.train.step import TrainState, make_train_step
from vps_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vps_torch.utils.numerics import train_policy


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class Runner:
    def __init__(self, detector, loader, cfg, work_dir: str,
                 total_epochs: int = 12, log_interval: int = 10,
                 ckpt_interval: int = 4, seed: int = 0, eval_fn=None,
                 eval_interval: int = 1):
        self.detector = detector
        self.loader = loader
        self.cfg = cfg
        self.work_dir = work_dir
        self.total_epochs = total_epochs
        self.log_interval = log_interval
        self.ckpt_interval = ckpt_interval
        self.seed = seed
        # post-epoch validation hook (mmdet's EvalHook): eval_fn(state,
        # epoch) -> dict of metrics, every eval_interval epochs
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.logger = logging.getLogger("vps_torch")
        # every logged record: epoch, iter, s/step, lr and the log vars
        self.log_history: List[Dict[str, Any]] = []

    def init_state(self) -> TrainState:
        opt = self.cfg.get("optimizer", {})
        lr_cfg = self.cfg.get("lr_config", {})
        schedule = build_lr_schedule(
            opt.get("lr", 0.005), self.loader.steps_per_epoch(),
            self.total_epochs, decay_epochs=lr_cfg.get("step", (8, 11)),
            warmup_iters=lr_cfg.get("warmup_iters", 500),
            warmup_ratio=lr_cfg.get("warmup_ratio", 1.0 / 3))
        opt_cfg = self.cfg.get("optimizer_config", {})
        optimizer, _ = build_optimizer(
            self.detector, schedule, momentum=opt.get("momentum", 0.9),
            weight_decay=opt.get("weight_decay", 1e-4),
            grad_clip=opt_cfg.get("grad_clip", {}).get("max_norm", 35.0),
            skip_nonfinite=opt_cfg.get("skip_nonfinite", 8))
        return TrainState(optimizer, 0)

    def _sync(self):
        if self.detector.device.type == "cuda":
            torch.cuda.synchronize(self.detector.device)

    def run(self, load_from: Optional[str] = None,
            resume_from: Optional[str] = None) -> TrainState:
        det = self.detector
        state = self.init_state()
        opt = state.optimizer
        start_epoch = 0
        if resume_from:
            restored = load_checkpoint(resume_from, {
                "state_dict": det.state_dict(), "opt_state": opt.state_dict()})
            det.load_state_dict(restored["state_dict"])
            opt.load_state_dict(restored["opt_state"])
            meta_path = resume_from + ".meta.json"
            if osp.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                start_epoch = int(meta.get("epoch", 0))
                state = state._replace(step=int(meta.get("step", 0)))
        elif load_from:
            restored = load_checkpoint(load_from,
                                       {"state_dict": det.state_dict()})
            det.load_state_dict(restored["state_dict"])

        with train_policy():
            step_fn = make_train_step(det, opt)
            gen = torch.Generator(device=det.device).manual_seed(
                self.seed + 12345)
            for epoch in range(start_epoch, self.total_epochs):
                self._sync()
                t_iter = time.perf_counter()
                for i, batch in enumerate(self.loader.epoch(epoch)):
                    state, log_vars = step_fn(
                        state, _to_device(batch, det.device), gen)
                    if (i + 1) % self.log_interval == 0:
                        self._sync()
                        dt = (time.perf_counter() - t_iter) / self.log_interval
                        vals = {k: float(v) for k, v in log_vars.items()}
                        self.log_history.append(dict(
                            epoch=epoch + 1, iter=i + 1, time=dt, **vals))
                        msg = ", ".join(f"{k}: {v:.4f}"
                                        for k, v in sorted(vals.items()))
                        self.logger.info(f"Epoch [{epoch + 1}][{i + 1}] "
                                         f"time: {dt:.3f}s, {msg}")
                        self._sync()
                        t_iter = time.perf_counter()
                if (epoch + 1) % self.ckpt_interval == 0 \
                        or epoch + 1 == self.total_epochs:
                    save_checkpoint(self.work_dir, state.step,
                                    det.state_dict(), opt.state_dict(),
                                    meta=dict(epoch=epoch + 1,
                                              step=state.step))
                if (self.eval_fn is not None
                        and (epoch + 1) % self.eval_interval == 0):
                    metrics = self.eval_fn(state, epoch + 1)
                    if metrics:
                        msg = ", ".join(f"{k}: {v:.4f}"
                                        for k, v in sorted(metrics.items()))
                        self.logger.info(f"Eval [{epoch + 1}] {msg}")
            return state
