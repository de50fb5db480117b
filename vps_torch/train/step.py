"""Train step (port of vps_tpu/train/step.py: ``parse_losses``,
``make_loss_fn`` and ``make_train_step``) on one device.

The JAX step vmaps the single-sample loss over the batch and takes the
mean; here the samples run one after another, then the mean. No mesh (DDP
is ROADMAP.md queue 1 item 12), no optimization barrier and no remat: those
were XLA:TPU workarounds.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

# per-sample fields of a batch; the first four keep a batch dim of 1
IMAGE_KEYS = ("img", "ref_img", "gt_semantic_seg", "gt_semantic_seg_Nx")
GT_KEYS = ("gt_bboxes", "gt_labels", "gt_valid", "gt_masks", "gt_pids",
           "ref_bboxes", "ref_valid")


class TrainState(NamedTuple):
    optimizer: object  # vps_torch.train.optim.Optimizer
    step: int


def parse_losses(losses: Dict[str, torch.Tensor]):
    """mmdet parse_losses: total = sum of the values whose key contains
    'loss'; the rest are logged metrics."""
    total = sum(v for k, v in losses.items() if "loss" in k)
    log_vars = dict(losses)
    log_vars["loss"] = total
    return total, log_vars


def make_loss_fn(detector) -> Callable:
    """loss_fn(batch, generator) -> (total, log_vars) over a leading batch
    dim B: the single-sample ``detector.loss`` per sample, each term's mean
    over the batch, then ``parse_losses``."""

    def loss_fn(batch, generator):
        b = batch["img"].shape[0]
        per = []
        for i in range(b):
            sample = {k: batch[k][i:i + 1] for k in IMAGE_KEYS}
            sample.update({k: batch[k][i] for k in GT_KEYS})
            per.append(detector.loss(**sample, generator=generator))
        losses = {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}
        return parse_losses(losses)

    return loss_fn


def make_train_step(detector, optimizer) -> Callable:
    """train_step(state, batch, generator) -> (state, log_vars): loss,
    backward, one optimizer update. log_vars are detached device scalars
    plus ``nonfinite_skips`` (the optimizer's count of skipped steps) and
    the step's ``lr``."""
    loss_fn = make_loss_fn(detector)

    def train_step(state: TrainState, batch, generator):
        lr = optimizer.lr()
        total, log_vars = loss_fn(batch, generator)
        total.backward()
        optimizer.step()
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        log_vars["nonfinite_skips"] = optimizer.total_notfinite
        log_vars["lr"] = lr
        return TrainState(state.optimizer, state.step + 1), log_vars

    return train_step
