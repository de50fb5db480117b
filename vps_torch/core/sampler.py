"""Pos/neg samplers (port of vps_tpu/core/sampler.py: ``SampleResult``,
``_sample_by_priority``, ``random_sample``, ``pseudo_sample``,
``ohem_sample``, ``instance_balanced_sample``, ``iou_balanced_neg_sample``
and ``combined_sample``), static shape: up to num * pos_fraction
positives, negatives fill the rest, positives first so the heads can slice
the positive prefix.

Draws come from an explicit ``torch.Generator`` through ``uniform``, the one
place every random number of the sampler is made (tests replace it to feed
the port and the JAX package the same priorities). Each random sampler
draws once, (2, N): row 0 the positives' priorities, row 1 the negatives',
JAX's rp and rn. The draws are not JAX's: ``jax.random`` cannot be
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


def _round_robin(group, members, r):
    """Priority of each candidate: how many members of its group have a
    smaller draw, plus its draw x 0.999, so each group gives its best slot
    before any gives a second (ties in the rank broken by the draw)."""
    same = (group[:, None] == group[None, :]) & members[None, :]
    rank = (same & (r[None, :] < r[:, None])).sum(1)
    return rank.float() + r * 0.999


def random_sample(generator, assigned_gt_inds, num: int,
                  pos_fraction: float) -> SampleResult:
    """assigned_gt_inds: (N,) from ``max_iou_assign``. Returns ``num``
    slots; positive and negative priorities are uniform draws."""
    rp, rn = _draws(generator, assigned_gt_inds)
    return _sample_by_priority(rp, rn, assigned_gt_inds > 0,
                               assigned_gt_inds == 0, num,
                               int(num * pos_fraction))


def pseudo_sample(assigned_gt_inds, num: int) -> SampleResult:
    """mmdet's PseudoSampler: no subsampling, every positive then every
    negative in index order, truncated to ``num`` slots."""
    idx = torch.arange(assigned_gt_inds.shape[0], dtype=torch.float32,
                       device=assigned_gt_inds.device)
    return _sample_by_priority(idx, idx, assigned_gt_inds > 0,
                               assigned_gt_inds == 0, num, num)


def ohem_sample(assigned_gt_inds, losses, num: int,
                pos_fraction: float) -> SampleResult:
    """OHEM (mmdet's OHEMSampler): the hardest candidates, those of the
    highest current loss, instead of random ones; ``losses`` (N,) from the
    hard-mining forward. The negated loss is the priority (lower first)."""
    hard = -losses
    return _sample_by_priority(hard, hard, assigned_gt_inds > 0,
                               assigned_gt_inds == 0, num,
                               int(num * pos_fraction))


def instance_balanced_sample(generator, assigned_gt_inds, num: int,
                             pos_fraction: float) -> SampleResult:
    """mmdet's InstanceBalancedPosSampler: positives spread evenly over the
    gt instances (each gt's random rank is the first sort key), random
    negatives."""
    is_pos = assigned_gt_inds > 0
    rp, rn = _draws(generator, assigned_gt_inds)
    return _sample_by_priority(_round_robin(assigned_gt_inds, is_pos, rp), rn,
                               is_pos, assigned_gt_inds == 0, num,
                               int(num * pos_fraction))


def _iou_bins(max_overlaps, lo: float, hi: float, num_bins: int):
    width = (hi - lo) / num_bins
    return torch.floor((max_overlaps - lo) / max(width, 1e-12)).clamp(
        0, num_bins - 1).long()


def iou_balanced_neg_sample(generator, assigned_gt_inds, max_overlaps,
                            num: int, pos_fraction: float,
                            floor_thr: float = -1.0,
                            floor_fraction: float = 0.0, num_bins: int = 3,
                            neg_iou_thr: float = 0.5) -> SampleResult:
    """mmdet's IoUBalancedNegSampler (Libra R-CNN): negatives drawn evenly
    from ``num_bins`` IoU bins over [max(floor_thr, 0), neg_iou_thr) (each
    bin's random rank is the first sort key), random positives.
    ``floor_fraction`` is accepted and unused, as in vps_tpu."""
    is_neg = assigned_gt_inds == 0
    rp, rn = _draws(generator, assigned_gt_inds)
    bins = _iou_bins(max_overlaps, max(floor_thr, 0.0), neg_iou_thr, num_bins)
    return _sample_by_priority(rp, _round_robin(bins, is_neg, rn),
                               assigned_gt_inds > 0, is_neg, num,
                               int(num * pos_fraction))


def combined_sample(generator, assigned_gt_inds, max_overlaps, num: int,
                    pos_fraction: float, **neg_kwargs) -> SampleResult:
    """mmdet's CombinedSampler as Libra R-CNN configures it:
    instance-balanced positives and IoU-balanced negatives over
    [0, neg_iou_thr) (``neg_kwargs``: num_bins, neg_iou_thr)."""
    is_pos, is_neg = assigned_gt_inds > 0, assigned_gt_inds == 0
    rp, rn = _draws(generator, assigned_gt_inds)
    bins = _iou_bins(max_overlaps, 0.0, neg_kwargs.get("neg_iou_thr", 0.5),
                     neg_kwargs.get("num_bins", 3))
    return _sample_by_priority(_round_robin(assigned_gt_inds, is_pos, rp),
                               _round_robin(bins, is_neg, rn), is_pos, is_neg,
                               num, int(num * pos_fraction))
