"""The mask-branch heads of the R-CNN zoo (port of
vps_tpu/models/mask_heads.py), their losses and training targets:

- FusedSemanticHead: HTC's multi-level fused semantic branch (lateral 1x1s,
  fused at one level, 3x3 convs, logits and an embedding).
- HTCMaskHead: FCNMaskHead with a 1x1 ``conv_res`` input for HTC's mask
  information flow.
- MaskIoUHead and ``mask_iou_target``: Mask Scoring R-CNN's mask-IoU
  regressor and its targets (box sums from one integral image of the gt
  masks, no per-RoI crop).
- GridHead, ``grid_target`` and ``grid_bboxes``: Grid R-CNN Plus's
  grid-point heatmaps with first- and second-order neighbour fusion (and in
  training the heatmaps of the features before it), their targets, and the
  boundary-voting decode, vectorised over RoIs.

Modules take NHWC RoI windows (R, S, S, C), as the port's other RoI heads
do, and compute NCHW inside; parameter names are mmdet's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, ConvModule, max_pool, resize_bilinear
from vps_torch.models.mask_head import FCNMaskHead
from vps_torch.ops.losses import (
    binary_cross_entropy_with_logits,
    softmax_cross_entropy,
)
from vps_torch.registry import HEADS


@HEADS.register
class FusedSemanticHead(nn.Module):
    """in_i -> 1x1 conv (+ ReLU), summed at ``fusion_level`` (the other
    levels resized bilinearly to it first), then ``num_convs`` 3x3 convs ->
    (1x1 logits, 1x1 embedding)."""

    def __init__(self, num_ins=5, fusion_level=1, num_convs=4, in_channels=256,
                 conv_out_channels=256, num_classes=183, ignore_label=255,
                 loss_weight=0.2, device=None):
        super().__init__()
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.ignore_label = ignore_label
        self.loss_weight = loss_weight
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, in_channels, 1, 1, 0, device=device)
            for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, 1, 1, device=device)
            for i in range(num_convs))
        self.conv_embedding = ConvModule(conv_out_channels, conv_out_channels,
                                         1, 1, 0, device=device)
        self.conv_logits = Conv(conv_out_channels, num_classes, 1, 1, 0,
                                device=device)

    def forward(self, feats):
        """feats: num_ins maps (B, C, H_l, W_l) -> (logits (B, K, h, w),
        embedding (B, C', h, w)) at the fusion level's size."""
        x = self.lateral_convs[self.fusion_level](feats[self.fusion_level])
        size = tuple(x.shape[-2:])
        for i, f in enumerate(feats):
            if i != self.fusion_level:
                x = x + self.lateral_convs[i](resize_bilinear(f, size))
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(x), self.conv_embedding(x)

    def loss(self, mask_pred, labels):
        """Cross entropy with ``ignore_label`` left out, x ``loss_weight``.
        mask_pred (B, K, h, w) logits; labels (B, h, w) int at their size."""
        return self.loss_weight * softmax_cross_entropy(
            mask_pred.permute(0, 2, 3, 1), labels,
            ignore_index=self.ignore_label)


@HEADS.register
class HTCMaskHead(FCNMaskHead):
    """FCNMaskHead plus ``conv_res``: the previous stage's pre-upsample
    features, through a 1x1 conv + ReLU, are added to the input.
    ``with_conv_res`` is False for a head that is never given them (the
    first stage, or any stage without mask information flow)."""

    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=9, with_conv_res: bool = True, device=None):
        super().__init__(num_convs, in_channels, conv_out_channels,
                         num_classes, device=device)
        self.conv_res = (ConvModule(conv_out_channels, conv_out_channels, 1, 1,
                                    0, device=device)
                         if with_conv_res else None)

    def forward(self, roi_feats, res_feat=None, return_logits: bool = True,
                return_feat: bool = True):
        """roi_feats (R, 14, 14, C); res_feat (R, C', 14, 14) or None.
        Returns the logits (R, K, 28, 28), the features (R, C', 14, 14), or
        both, as asked."""
        x = roi_feats.permute(0, 3, 1, 2)
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        outs = []
        if return_logits:
            outs.append(self.conv_logits(F.relu(self.upsample(x))))
        if return_feat:
            outs.append(x)
        return tuple(outs) if len(outs) > 1 else outs[0]


@HEADS.register
class MaskIoUHead(nn.Module):
    """Mask-IoU regressor: concat(mask features 14x14, the max-pooled
    sigmoid of the mask logits) -> ``num_convs`` 3x3 convs (the last stride
    2) -> ``num_fcs`` FCs -> an IoU a class."""

    def __init__(self, num_convs=4, num_fcs=2, roi_feat_size=14,
                 in_channels=256, conv_out_channels=256, fc_out_channels=1024,
                 num_classes=9, loss_weight=0.5, device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv(in_channels + 1 if i == 0 else conv_out_channels,
                 conv_out_channels, 3, 2 if i == num_convs - 1 else 1, 1,
                 device=device)
            for i in range(num_convs))
        self.loss_weight = loss_weight
        pooled = (roi_feat_size // 2) ** 2
        dims = [conv_out_channels * pooled] + [fc_out_channels] * num_fcs
        self.fcs = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(num_fcs))
        self.fc_mask_iou = nn.Linear(dims[-1], num_classes, device=device)

    def forward(self, mask_feat, mask_pred):
        """mask_feat (R, S, S, C); mask_pred (R, 2S, 2S) logits of each
        RoI's class -> (R, num_classes) IoU predictions."""
        prob = max_pool(torch.sigmoid(mask_pred)[:, None], 2, 2, 0)
        x = torch.cat([mask_feat.permute(0, 3, 1, 2), prob], 1)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x)

    def loss(self, pos_iou_pred, iou_targets, pos_valid):
        """x ``loss_weight``, the mean squared error over the valid
        positives whose target is above 0."""
        w = (pos_valid & (iou_targets > 0)).float()
        den = w.sum().clamp(min=1.0)
        return self.loss_weight * (w * (pos_iou_pred - iou_targets) ** 2
                                   ).sum() / den


def mask_iou_target(pos_rois, pos_gt_idx, pos_valid, gt_masks, mask_pred,
                    mask_targets, thr: float = 0.5):
    """The IoU of each positive's binarised mask (sigmoid > ``thr``) with
    its whole gt instance. Inside the RoI that is the 28x28 target; the gt's
    area outside comes from area_ratio = gt area in the box / gt area, both
    from one integral image of the gt stack (inclusive boxes, coordinates
    truncated to int). pos_rois (P, 4); pos_gt_idx (P,); gt_masks (G, H, W)
    {0, 1}; mask_pred (P, 28, 28) logits; mask_targets (P, 28, 28).
    Returns (P,), 0 where not ``pos_valid``."""
    g, h, w = gt_masks.shape
    ii = F.pad(gt_masks.float().cumsum(1).cumsum(2), (1, 0, 1, 0))
    x1 = pos_rois[:, 0].int().clamp(0, w)
    y1 = pos_rois[:, 1].int().clamp(0, h)
    x2 = (pos_rois[:, 2].int() + 1).clamp(0, w)
    y2 = (pos_rois[:, 3].int() + 1).clamp(0, h)
    gi = pos_gt_idx.long()
    in_box = (ii[gi, y2, x2] - ii[gi, y1, x2] - ii[gi, y2, x1]
              + ii[gi, y1, x1])
    full = gt_masks.float().sum((1, 2))[gi]
    area_ratio = in_box / full.clamp(min=1e-7)
    pred_bin = (torch.sigmoid(mask_pred) > thr).float()
    pred_area = pred_bin.sum((1, 2))
    overlap = (pred_bin * mask_targets).sum((1, 2))
    gt_full = mask_targets.sum((1, 2)) / area_ratio.clamp(min=1e-7)
    iou = overlap / (pred_area + gt_full - overlap).clamp(min=1e-7)
    return torch.where(pos_valid, iou, torch.zeros_like(iou))


# ---------------------------------------------------------------------------
# Grid R-CNN
# ---------------------------------------------------------------------------


def _grid_geometry(grid_points: int, roi_feat_size: int):
    """The grid's side, the whole and half heatmap sizes, the static corner
    of each grid point's sub-region window, and each point's interpolation
    factors (fx, fy) between the gt box's (x1, y1) and (x2, y2)."""
    grid_size = int(np.sqrt(grid_points))
    whole = roi_feat_size * 4
    half = whole // 4 * 2
    subs, factors = [], []
    for j in range(grid_points):
        corner = []
        for idx in (j // grid_size, j % grid_size):  # x, then y
            if idx == 0:
                corner.append(0)
            elif idx == grid_size - 1:
                corner.append(half)
            else:
                corner.append(max(int((idx / (grid_size - 1) - 0.25) * whole),
                                  0))
        subs.append(tuple(corner))
        factors.append((1 - (j // grid_size) / (grid_size - 1),
                        1 - (j % grid_size) / (grid_size - 1)))
    return grid_size, whole, half, subs, factors


def _neighbors(gsz: int):
    """The 4-neighbourhood of each point of a gsz x gsz grid, in the order
    up, left, right, down."""
    out = []
    for i in range(gsz):
        for j in range(gsz):
            n = []
            if i > 0:
                n.append((i - 1) * gsz + j)
            if j > 0:
                n.append(i * gsz + j - 1)
            if j < gsz - 1:
                n.append(i * gsz + j + 1)
            if i < gsz - 1:
                n.append((i + 1) * gsz + j)
            out.append(n)
    return out


class _ConvGN(nn.Module):
    """conv -> GroupNorm -> ReLU (mmdet ConvModule naming: ``conv``, ``gn``)."""

    def __init__(self, cin, cout, k, stride, padding, groups, device=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, padding, device=device)
        self.gn = nn.GroupNorm(groups, cout, eps=1e-5, device=device)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


@HEADS.register
class GridHead(nn.Module):
    """Grid-point heatmap head: ``num_convs`` convs (the first stride 2, GN)
    over point-grouped channels, first- and second-order neighbour fusion
    (a depthwise 5x5 and a 1x1 conv an edge), two grouped deconvs to a
    ``grid_points``-channel heatmap of twice the RoI window."""

    def __init__(self, grid_points=9, num_convs=8, roi_feat_size=14,
                 in_channels=256, conv_kernel_size=3, point_feat_channels=64,
                 norm_groups=36, device=None):
        super().__init__()
        gsz = int(np.sqrt(grid_points))
        assert gsz * gsz == grid_points
        self.grid_points = grid_points
        self.roi_feat_size = roi_feat_size
        self.point_feat_channels = c = point_feat_channels
        out_ch = c * grid_points
        pad = (conv_kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            _ConvGN(in_channels if i == 0 else out_ch, out_ch,
                    conv_kernel_size, 2 if i == 0 else 1, pad, norm_groups,
                    device)
            for i in range(num_convs))
        self.neighbor_points = _neighbors(gsz)

        def trans():
            return nn.ModuleList(
                nn.ModuleList(
                    nn.Sequential(Conv(c, c, 5, 1, 2, device=device, groups=c),
                                  Conv(c, c, 1, 1, 0, device=device))
                    for _ in nbrs)
                for nbrs in self.neighbor_points)

        self.forder_trans = trans()
        self.sorder_trans = trans()
        self.deconv1 = nn.ConvTranspose2d(out_ch, out_ch, 4, 2, 1,
                                          groups=grid_points, device=device)
        self.norm1 = nn.GroupNorm(grid_points, out_ch, eps=1e-5, device=device)
        self.deconv2 = nn.ConvTranspose2d(out_ch, grid_points, 4, 2, 1,
                                          groups=grid_points, device=device)

    def forward(self, x, train: bool = False):
        """x (R, S, S, C) -> fused heatmap logits (R, 2S, 2S, grid_points),
        NHWC; with ``train`` (fused, unfused), the unfused heatmaps from the
        features before the neighbour fusion through the same deconvs."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = conv(x)
        c = self.point_feat_channels
        pts = [x[:, i * c:(i + 1) * c] for i in range(self.grid_points)]
        x_fo = []
        for i, nbrs in enumerate(self.neighbor_points):
            acc = pts[i]
            for j, p in enumerate(nbrs):
                acc = acc + self.forder_trans[i][j](pts[p])
            x_fo.append(acc)
        x_so = []
        for i, nbrs in enumerate(self.neighbor_points):
            acc = pts[i]
            for j, p in enumerate(nbrs):
                acc = acc + self.sorder_trans[i][j](x_fo[p])
            x_so.append(acc)
        fused = self._heatmap(torch.cat(x_so, 1))
        if train:
            return fused, self._heatmap(x)
        return fused

    def _heatmap(self, x):
        x = F.relu(self.norm1(self.deconv1(x)))
        return self.deconv2(x).permute(0, 2, 3, 1)

    def loss(self, fused, unfused, targets, valid, loss_weight: float = 15.0):
        """Sigmoid cross entropy of both heatmaps against ``targets`` (R,
        h, h, P), each the mean over the valid RoIs' elements, their sum x
        ``loss_weight``."""
        w = valid.float()[:, None, None, None]
        den = w.sum().clamp(min=1.0) * int(np.prod(targets.shape[1:]))
        return loss_weight * (
            binary_cross_entropy_with_logits(fused, targets, weight=w,
                                             avg_factor=den)
            + binary_cross_entropy_with_logits(unfused, targets, weight=w,
                                               avg_factor=den))


def grid_target(pos_rois, pos_gt_bboxes, pos_valid, grid_points: int = 9,
                roi_feat_size: int = 14, pos_radius: int = 1):
    """Grid-point heatmap targets, vectorised: for each RoI (its window
    doubled about its centre) and grid point, the disc of ``pos_radius``
    around the gt box's point in that point's sub-region window. Returns
    (P, half, half, grid_points) NHWC {0, 1}; 0 for a RoI not valid or not
    wider and taller than the grid."""
    gsz, whole, half, subs, factors = _grid_geometry(grid_points,
                                                     roi_feat_size)
    x1 = pos_rois[:, 0] - (pos_rois[:, 2] - pos_rois[:, 0]) / 2
    y1 = pos_rois[:, 1] - (pos_rois[:, 3] - pos_rois[:, 1]) / 2
    ws = (pos_rois[:, 2] - pos_rois[:, 0]) * 2
    hs = (pos_rois[:, 3] - pos_rois[:, 1]) * 2
    ok = pos_valid & (ws > gsz) & (hs > gsz)
    ar = torch.arange(half, device=pos_rois.device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    chans = []
    for j in range(grid_points):
        fx, fy = factors[j]
        gx = fx * pos_gt_bboxes[:, 0] + (1 - fx) * pos_gt_bboxes[:, 2]
        gy = fy * pos_gt_bboxes[:, 1] + (1 - fy) * pos_gt_bboxes[:, 3]
        cx = ((gx - x1) / ws.clamp(min=1e-6) * whole).int()
        cy = ((gy - y1) / hs.clamp(min=1e-6) * whole).int()
        # shift into this point's sub-region window
        dx = xx[None] + subs[j][0] - cx[:, None, None]
        dy = yy[None] + subs[j][1] - cy[:, None, None]
        hit = (dx * dx + dy * dy) <= pos_radius * pos_radius
        chans.append(hit & ok[:, None, None])
    return torch.stack(chans, -1).float()


def grid_bboxes(det_bboxes, heatmaps, img_shape, grid_points: int = 9,
                roi_feat_size: int = 14):
    """Boundary-voting box refinement (mmdet grid_head.py get_bboxes),
    vectorised: each grid point's most confident heatmap cell, in image
    coordinates, and each border the score-weighted mean of its points.
    det_bboxes (R, 4); heatmaps (R, half, half, P) fused logits NHWC.
    Returns (R, 4) boxes clipped to img_shape."""
    gsz, whole, half, subs, _ = _grid_geometry(grid_points, roi_feat_size)
    r = det_bboxes.shape[0]
    dev = det_bboxes.device
    prob = torch.sigmoid(heatmaps)
    flat = prob.permute(0, 3, 1, 2).reshape(r, grid_points, half * half)
    pos = flat.argmax(-1)  # (R, P); the first cell on ties
    score = flat.amax(-1)
    sub_x = torch.tensor([s[0] for s in subs], device=dev)
    sub_y = torch.tensor([s[1] for s in subs], device=dev)
    xs = pos % half + sub_x[None]
    ys = torch.div(pos, half, rounding_mode="floor") + sub_y[None]

    widths = (det_bboxes[:, 2] - det_bboxes[:, 0])[:, None]
    heights = (det_bboxes[:, 3] - det_bboxes[:, 1])[:, None]
    x1 = det_bboxes[:, 0][:, None] - widths / 2
    y1 = det_bboxes[:, 1][:, None] - heights / 2
    abs_xs = (xs.float() + 0.5) / whole * (widths * 2) + x1
    abs_ys = (ys.float() + 0.5) / whole * (heights * 2) + y1

    def vote(vals, idx):
        s = score[:, idx]
        return (vals[:, idx] * s).sum(1) / s.sum(1).clamp(min=1e-6)

    idx = torch.arange(gsz, device=dev)
    h, w = img_shape
    bx1 = vote(abs_xs, idx).clamp(0, w - 1)
    by1 = vote(abs_ys, idx * gsz).clamp(0, h - 1)
    bx2 = vote(abs_xs, grid_points - gsz + idx).clamp(0, w - 1)
    by2 = vote(abs_ys, (idx + 1) * gsz - 1).clamp(0, h - 1)
    return torch.stack([bx1, by1, bx2, by2], -1)
