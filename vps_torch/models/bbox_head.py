"""SharedFCBBoxHead (port of vps_tpu/models/bbox_head.py): flattened ROI
features -> shared FCs -> cls (C+1) and class-specific reg (4(C+1)). The
first FC takes torch's (C, H, W) flattening, as the mmdet weights do."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class SharedFCBBoxHead(nn.Module):
    def __init__(self, num_fcs=2, in_channels=256, fc_out_channels=1024,
                 roi_feat_size=7, num_classes=9, reg_class_agnostic=False,
                 device=None):
        super().__init__()
        dims = [in_channels * roi_feat_size * roi_feat_size] + \
            [fc_out_channels] * num_fcs
        self.shared_fcs = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(num_fcs))
        self.num_classes = num_classes
        self.fc_cls = nn.Linear(fc_out_channels, num_classes, device=device)
        reg_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_reg = nn.Linear(fc_out_channels, reg_dim, device=device)

    def forward(self, roi_feats):
        """roi_feats (R, 7, 7, C) -> (cls logits (R, K), deltas (R, 4K))."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)
