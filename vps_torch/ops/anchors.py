"""Anchor generation (port of vps_tpu/ops/anchors.py): the reference's legacy
rounding and 0.5*(s-1) centring; grid anchors enumerate location-major with
the A anchors of one location contiguous."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    def __init__(self, base_size: float, scales: Sequence[float],
                 ratios: Sequence[float]):
        self.base_size = base_size
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.base_anchors = self._gen_base_anchors()

    def _gen_base_anchors(self) -> np.ndarray:
        w = h = self.base_size
        x_ctr = 0.5 * (w - 1)
        y_ctr = 0.5 * (h - 1)
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        base = np.stack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                         x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], -1)
        return np.round(base).astype(np.float32)

    def grid_anchors(self, featmap_size: Tuple[int, int], stride: int,
                     device=None) -> torch.Tensor:
        """(feat_h * feat_w * A, 4) anchors."""
        feat_h, feat_w = featmap_size
        base = torch.from_numpy(self.base_anchors).to(device)
        shift_x = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
        shift_y = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
        sx = shift_x.repeat(feat_h)
        sy = shift_y.repeat_interleave(feat_w)
        shifts = torch.stack([sx, sy, sx, sy], dim=-1)
        return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
