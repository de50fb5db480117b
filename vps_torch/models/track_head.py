"""Track head (port of vps_tpu/models/track_head.py): shared FCs on
flattened ROI features of the current and reference frame, a dot-product
match matrix with a prepended all-zero "new object" column, and the
comprehensive matching score; ``track_match_loss`` for training."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class TrackHead(nn.Module):
    def __init__(self, num_fcs=2, in_channels=256, roi_feat_size=7,
                 fc_out_channels=1024, device=None):
        super().__init__()
        dims = [in_channels * roi_feat_size * roi_feat_size] + \
            [fc_out_channels] * num_fcs
        self.fcs = nn.ModuleList(nn.Linear(dims[i], dims[i + 1], device=device)
                                 for i in range(num_fcs))

    def embed(self, x):
        """x (N, 7, 7, C) -> (N, fc_out)."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = F.relu(x)
        return x

    def forward(self, x, ref_x, ref_valid=None):
        """x (N, 7, 7, C), ref_x (M, 7, 7, C), ref_valid (M,) -> match logits
        (N, M+1): column 0 is the zero "new object" logit, invalid reference
        columns are -1e10."""
        prod = self.embed(x) @ self.embed(ref_x).t()
        if ref_valid is not None:
            prod = torch.where(ref_valid[None, :], prod,
                               torch.full_like(prod, -1e10))
        dummy = torch.zeros((prod.shape[0], 1), dtype=prod.dtype,
                            device=prod.device)
        return torch.cat([dummy, prod], 1)


def compute_comp_scores(match_ll, bbox_scores, bbox_ious, label_delta,
                        match_coeff=(1.0, 2.0, 10.0)):
    """track_head.py:73-91 comprehensive score. match_ll (N, M+1); the other
    terms (N, M) get the dummy column (iou 0, label delta 1)."""
    n = match_ll.shape[0]
    bbox_ious = torch.cat([torch.zeros((n, 1), dtype=bbox_ious.dtype,
                                       device=bbox_ious.device), bbox_ious], 1)
    label_delta = torch.cat([torch.ones((n, 1), dtype=label_delta.dtype,
                                        device=label_delta.device),
                             label_delta], 1)
    return (match_ll
            + match_coeff[0] * torch.log(bbox_scores.clamp(min=1e-12))
            + match_coeff[1] * bbox_ious
            + match_coeff[2] * label_delta)


def track_match_loss(match_logits, ids, id_weights):
    """track_head.py:135-174: weighted cross entropy over the match columns,
    and the match accuracy. match_logits (N, M+1); ids (N,) target column
    (0 = new object); id_weights (N,) {0, 1}, 0 for padded rows."""
    logp = F.log_softmax(match_logits, dim=-1)
    n_valid = id_weights.sum().clamp(min=1.0)
    ids_safe = ids.long().clamp(0, match_logits.shape[1] - 1)
    ll = logp.gather(1, ids_safe[:, None])[:, 0]
    loss = -(ll * id_weights).sum() / n_valid
    acc = ((match_logits.argmax(-1) == ids).float() * id_weights).sum() / n_valid
    return loss, acc
