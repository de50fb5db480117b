"""The random sampler (port of vps_tpu/core/sampler.py: ``SampleResult``,
``_sample_by_priority`` and ``random_sample``), static shape: up to
num * pos_fraction positives, negatives fill the rest, positives first so
the heads can slice the positive prefix.

Draws come from an explicit ``torch.Generator`` through ``uniform``, the one
place every random number of the sampler is made. The sampler draws once,
(2, N): row 0 the positives' priorities, row 1 the negatives', JAX's rp and
rn. The draws are not JAX's: ``jax.random`` cannot be
reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SampleResult(NamedTuple):
    inds: torch.Tensor  # (num,) indices into the candidate set
    pos_mask: torch.Tensor  # (num,) True for positive slots (a prefix)
    valid: torch.Tensor  # (num,) slot validity
    num_pos: torch.Tensor  # scalar
    num_neg: torch.Tensor  # scalar


def uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` from ``generator`` (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device)


def _norm(p, mask):
    """Priorities under ``mask`` scaled into [0, 1 - 1e-6]."""
    inf = torch.tensor(float("inf"), device=p.device)
    p = torch.where(mask, p, torch.zeros_like(p))
    lo = torch.where(mask, p, inf).min()
    hi = torch.where(mask, p, -inf).max()
    rng = (hi - lo).clamp(min=1e-12)
    return ((p - lo) / rng).clamp(0.0, 1.0) * (1.0 - 1e-6)


def _sample_by_priority(pos_prio, neg_prio, is_pos, is_neg, num: int,
                        max_pos: int) -> SampleResult:
    """Keep the ``max_pos`` best-priority positives (lower first), fill the
    remaining slots with the best-priority negatives; positives take a slot
    prefix. Sorts are stable, as jnp.argsort's."""
    inf = torch.tensor(float("inf"), device=pos_prio.device)
    pk = torch.where(is_pos, pos_prio, inf)
    pos_rank = torch.argsort(torch.argsort(pk, stable=True), stable=True)
    kept_pos = is_pos & (pos_rank < max_pos)
    # disjoint bands: kept positives [0, 1), negatives [1, 2), the rest inf
    prio = torch.where(kept_pos, _norm(pos_prio, kept_pos),
                       torch.where(is_neg, 1.0 + _norm(neg_prio, is_neg), inf))
    inds = torch.argsort(prio, stable=True)[:num]
    slot_prio = prio[inds]
    valid = torch.isfinite(slot_prio)
    pos_mask = slot_prio < 1.0
    return SampleResult(inds, pos_mask, valid, pos_mask.sum(),
                        (valid & ~pos_mask).sum())


def _draws(generator, assigned_gt_inds):
    """(rp, rn): the positives' and the negatives' uniform priorities."""
    r = uniform(generator, (2, assigned_gt_inds.shape[0]),
                assigned_gt_inds.device)
    return r[0], r[1]


def random_sample(generator, assigned_gt_inds, num: int,
                  pos_fraction: float) -> SampleResult:
    """assigned_gt_inds: (N,) from ``max_iou_assign``. Returns ``num``
    slots; positive and negative priorities are uniform draws."""
    rp, rn = _draws(generator, assigned_gt_inds)
    return _sample_by_priority(rp, rn, assigned_gt_inds > 0,
                               assigned_gt_inds == 0, num,
                               int(num * pos_fraction))


