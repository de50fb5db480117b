"""Train step (port of vps_tpu/train/step.py: ``parse_losses``,
``make_loss_fn`` and ``make_train_step``), on one device.

The JAX step vmaps the single-sample loss over the batch and takes the
mean; here the samples run one after another, then the mean. No
optimization barrier and no remat: those were XLA:TPU workarounds.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch


# per-sample fields of a batch; the first four keep a batch dim of 1
IMAGE_KEYS = ("img", "ref_img", "gt_semantic_seg", "gt_semantic_seg_Nx")
GT_KEYS = ("gt_bboxes", "gt_labels", "gt_valid", "gt_masks", "gt_pids",
           "ref_bboxes", "ref_valid")
# spreads the per-sample seeds of one step over the 64-bit seed space
_GOLDEN = 0x9E3779B97F4A7C15


class TrainState(NamedTuple):
    optimizer: object  # reference.vpsref.train.optim.Optimizer
    step: int


def parse_losses(losses: Dict[str, torch.Tensor]):
    """mmdet parse_losses: total = sum of the values whose key contains
    'loss'; the rest are logged metrics."""
    total = sum(v for k, v in losses.items() if "loss" in k)
    log_vars = dict(losses)
    log_vars["loss"] = total
    return total, log_vars


def sample_generators(generator: torch.Generator, first: int, n: int):
    """Generators of the samples ``first .. first + n - 1`` of the global
    batch: one 63-bit draw from ``generator`` (which every rank seeds and
    advances alike), mixed with each sample's global index. A sample's draws
    depend on the step and its index only, not on how the global batch is
    split over the ranks, as JAX's ``jax.random.split`` of one key over the
    batch gives (``vps_tpu/train/step.py``)."""
    dev = generator.device
    key = int(torch.randint(2 ** 63 - 1, (), generator=generator, device=dev))
    return [torch.Generator(device=dev).manual_seed(
        (key + (first + i + 1) * _GOLDEN) % 2 ** 64) for i in range(n)]


def make_loss_fn(detector) -> Callable:
    """loss_fn(batch, generator) -> (total, log_vars) over a leading batch
    dim B: the single-sample ``detector.loss`` per sample, each with its
    generator from ``sample_generators``, each term's mean over the batch,
    then ``parse_losses``."""

    def loss_fn(batch, generator):
        b = batch["img"].shape[0]
        gens = sample_generators(generator, 0, b)
        per = []
        for i in range(b):
            sample = {k: batch[k][i:i + 1] for k in IMAGE_KEYS}
            sample.update({k: batch[k][i] for k in GT_KEYS})
            per.append(detector.loss(**sample, generator=gens[i]))
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
