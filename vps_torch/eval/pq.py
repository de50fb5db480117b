"""Panoptic-Quality statistics (the port's copy of the JAX package's
``eval/pq.py``: the PQStat contract of the reference's eval_vpq)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple


class PQStatCat:
    __slots__ = ("iou", "tp", "fp", "fn")

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def __iadd__(self, other: "PQStatCat"):
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


class PQStat:
    def __init__(self):
        self.pq_per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, cat_id: int) -> PQStatCat:
        return self.pq_per_cat[cat_id]

    def __iadd__(self, other: "PQStat"):
        for cat, stat in other.pq_per_cat.items():
            self.pq_per_cat[cat] += stat
        return self

    def pq_average(
        self, categories: Dict[int, dict], isthing: Optional[bool] = None
    ) -> Tuple[dict, dict]:
        pq = sq = rq = 0.0
        n = 0
        per_class = {}
        for cat_id, info in categories.items():
            if isthing is not None and (info["isthing"] == 1) != isthing:
                continue
            s = self.pq_per_cat[cat_id]
            denom = s.tp + 0.5 * s.fp + 0.5 * s.fn
            if denom == 0:
                per_class[cat_id] = dict(pq=0.0, sq=0.0, rq=0.0, iou=0.0,
                                         tp=0, fp=0, fn=0)
                continue
            n += 1
            pq_c = s.iou / denom
            sq_c = s.iou / s.tp if s.tp else 0.0
            rq_c = s.tp / denom
            per_class[cat_id] = dict(pq=pq_c, sq=sq_c, rq=rq_c, iou=s.iou,
                                     tp=s.tp, fp=s.fp, fn=s.fn)
            pq += pq_c
            sq += sq_c
            rq += rq_c
        n = max(n, 1)
        return dict(pq=pq / n, sq=sq / n, rq=rq / n, n=n), per_class
