"""TCEA temporal/spatial attention fusion (port of
vps_tpu/models/flow/tcea.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn

from reference.vpsref.models.layers import (
    Conv,
    avg_pool,
    leaky_relu,
    max_pool,
    resize_bilinear,
)


class TCEAFusion(nn.Module):
    def __init__(self, nf: int = 256, nframes: int = 2, center: int = 0,
                 dtype=None, device=None):
        super().__init__()
        self.center = center
        kw = dict(dtype=dtype, device=device)
        self.tAtt_1 = Conv(nf, nf, 3, 1, 1, **kw)
        self.tAtt_2 = Conv(nf, nf, 3, 1, 1, **kw)
        self.fea_fusion = Conv(nframes * nf, nf, 1, 1, 0, **kw)
        self.sAtt_1 = Conv(nframes * nf, nf, 1, 1, 0, **kw)
        self.sAtt_2 = Conv(nf * 2, nf, 1, 1, 0, **kw)
        self.sAtt_3 = Conv(nf, nf, 3, 1, 1, **kw)
        self.sAtt_4 = Conv(nf, nf, 3, 1, 1, **kw)
        self.sAtt_add_1 = Conv(nf, nf, 1, 1, 0, **kw)
        self.sAtt_add_2 = Conv(nf, nf, 1, 1, 0, **kw)

    def forward(self, aligned):
        """aligned: (B, N, C, H, W) -> fused (B, C, H, W)."""
        b, n, c, h, w = aligned.shape
        emb_ref = self.tAtt_2(aligned[:, self.center])
        emb = self.tAtt_1(aligned.reshape(b * n, c, h, w)).reshape(b, n, -1, h, w)
        # frame-center correlation accumulates in f32
        cor = torch.sum(emb.float() * emb_ref[:, None].float(), dim=2)
        cor_prob = torch.sigmoid(cor)[:, :, None].to(aligned.dtype)
        fea_w = (aligned * cor_prob).reshape(b, n * c, h, w)

        fea = leaky_relu(self.fea_fusion(fea_w))
        att = leaky_relu(self.sAtt_1(fea_w))
        att = leaky_relu(self.sAtt_2(torch.cat(
            [max_pool(att, 3, 2, 1), avg_pool(att, 3, 2, 1)], 1)))
        att = leaky_relu(self.sAtt_3(att))
        att = self.sAtt_4(resize_bilinear(att, (h, w)))
        att_add = self.sAtt_add_2(leaky_relu(self.sAtt_add_1(att)))
        att = torch.sigmoid(att.float()).to(fea.dtype)
        return fea * att * 2.0 + att_add
