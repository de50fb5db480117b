"""Optimizer and LR schedule (port of vps_tpu/train/optim.py): SGD lr 0.005,
momentum 0.9, weight decay 1e-4, global-norm clip 35, linear warmup over 500
iterations from 1/3, x0.1 at epochs 8 and 11 (configs/cityscapes/
fusetrack.py:226-233), and the non-finite skip.

The update is JAX's optax chain, in its order and with its products:
``apply_if_finite(masked(chain(clip_by_global_norm, add_decayed_weights,
sgd(schedule, momentum))))``. ``torch.optim.SGD`` does not carry it: it
folds -lr into one multiply-add (``p.add_(buf, alpha=-lr)``) where optax
rounds -lr * trace first, and it has neither the skip nor a schedule that
counts applied updates only. The arithmetic runs as ``torch._foreach_*``
ops over the trainable parameters, in place (so every update bumps each
parameter's version counter).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch


def trainable_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable}. The model decides: FlowNet2 and, for
    ``frozen_stages = s``, the backbone's stem and stages 1..s have
    requires_grad off (JAX's ``_frozen_path`` names the same set)."""
    return {n: p.requires_grad for n, p in model.named_parameters()}


def build_lr_schedule(base_lr: float, steps_per_epoch: int, total_epochs: int,
                      decay_epochs: Sequence[int] = (8, 11),
                      warmup_iters: int = 500, warmup_ratio: float = 1.0 / 3.0,
                      gamma: float = 0.1) -> Callable[[int], np.float32]:
    """mmcv's StepLrUpdater with linear warmup: the lr ramps from
    base * ratio to base over warmup_iters, then x gamma at each decay
    epoch. Computed in float32, as JAX computes it."""
    f32 = np.float32
    decay_steps = np.asarray([e * steps_per_epoch for e in decay_epochs],
                             np.float32)

    def schedule(step: int) -> np.float32:
        s = f32(step)
        lr = f32(base_lr) * f32(gamma) ** f32(np.sum(s >= decay_steps))
        k = min(s, f32(warmup_iters))
        wf = f32(1.0) - (f32(1.0) - k / f32(warmup_iters)) * f32(1.0 - warmup_ratio)
        return f32(lr * wf) if s < warmup_iters else f32(lr)

    return schedule


class Optimizer:
    """SGD with momentum, weight decay and global-norm clipping over the
    trainable parameters, skipping steps with non-finite gradients.

    ``step`` reads the gradients (``.grad``; a parameter without one counts
    as a zero gradient), and:
      * if any gradient is non-finite, counts it (``notfinite_count``,
        ``total_notfinite``) and leaves the parameters, the momentum and the
        schedule's count as they are, unless this is the
        (skip_nonfinite + 1)-th bad step in a row, which goes through as
        optax's ``apply_if_finite`` lets it;
      * else clips to ``grad_clip`` by the global norm (t / norm * max),
        adds weight_decay * p, updates the trace (g + momentum * trace) and
        adds -lr * trace, lr = schedule(count of applied updates).
    One host sync a step reads the finite flag and the norm."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter], schedule,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip: float = 35.0, skip_nonfinite: int = 8):
        self.names = list(named_params)
        self.params = list(named_params.values())
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # applied updates: the schedule's step
        self.notfinite_count = 0
        self.total_notfinite = 0

    def lr(self) -> float:
        return float(self.schedule(self.count))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one update; returns False when the step was skipped."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        self.zero_grad()
        amax = torch.stack(torch._foreach_norm(grads, float("inf")))
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        finite, g_norm = torch.stack(
            [torch.isfinite(amax).all().float(), norm]).tolist()
        if self.skip_nonfinite > 0:
            if finite:
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= self.skip_nonfinite:
                    return False
        if not g_norm < self.grad_clip:
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.grad_clip)
        grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        updates = torch._foreach_mul(self.trace, -self.lr())
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"trace": dict(zip(self.names, self.trace)), "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for name, t in zip(self.names, self.trace):
                t.copy_(state["trace"][name])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])


def build_optimizer(model: torch.nn.Module, schedule, momentum: float = 0.9,
                    weight_decay: float = 1e-4, grad_clip: float = 35.0,
                    skip_nonfinite: int = 8):
    """The optimizer over ``model``'s trainable parameters, and the mask.
    Frozen parameters never receive a gradient, so they stay fixed, as
    JAX's stop_gradient and optax.masked keep them."""
    mask = trainable_mask(model)
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    return Optimizer(params, schedule, momentum, weight_decay, grad_clip,
                     skip_nonfinite), mask
