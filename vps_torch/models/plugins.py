"""Backbone plugins (port of vps_tpu/models/plugins.py): GCNet's
``ContextBlock`` and the empirical attention block ``GeneralizedAttention``
that the ResNet's bottlenecks can mount; NCHW, mmdet's state_dict names.

Both compute in f32 whatever the block's compute dtype (their convs have
none, as in JAX). The ContextBlock's LayerNorm is flax's, as the JAX
package's is: epsilon 1e-6 (mmdet's and torch's default is 1e-5) and the
variance as E[x^2] - E[x]^2 clipped at 0 (torch's takes E[(x - E[x])^2]).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the (C, H, W) of an NCHW map: the
    variance as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance; its
    rounding differs from torch's two-pass LayerNorm where the mean is large
    against the spread, as after the ContextBlock's pooling), epsilon 1e-6,
    mmdet's (C, H, W)-shaped weight and bias."""

    def __init__(self, shape, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(shape, device=device))

    def forward(self, x):
        dims = tuple(range(1, x.dim()))
        mu = x.mean(dims, keepdim=True)
        var = ((x * x).mean(dims, keepdim=True) - mu * mu).clamp(min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ContextBlock(nn.Module):
    """GCNet context block: softmax-attention (``att``) or mean (``avg``)
    global pooling, a bottleneck transform (1x1 conv, LayerNorm over the
    channels, ReLU, 1x1 conv) and a channel-wise sigmoid product
    (``channel_mul``) and/or sum (``channel_add``) with the input. Names:
    ``conv_mask``, ``channel_add_conv.{0,1,3}``, ``channel_mul_conv...``
    (the LayerNorm's weight is (planes, 1, 1), as mmdet's)."""

    def __init__(self, inplanes: int, ratio: float = 1.0 / 16.0,
                 pooling_type: str = "att",
                 fusion_types: Sequence[str] = ("channel_add",), device=None):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise ValueError(f"ContextBlock: pooling_type {pooling_type!r}")
        planes = max(int(inplanes * ratio), 1)
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        self.conv_mask = (Conv(inplanes, 1, 1, 1, 0, device=device)
                          if pooling_type == "att" else None)

        def transform():
            return nn.Sequential(
                Conv(inplanes, planes, 1, 1, 0, device=device),
                LayerNorm((planes, 1, 1), device=device),
                nn.ReLU(),
                Conv(planes, inplanes, 1, 1, 0, device=device))

        self.channel_add_conv = (transform() if "channel_add" in
                                 self.fusion_types else None)
        self.channel_mul_conv = (transform() if "channel_mul" in
                                 self.fusion_types else None)

    def forward(self, x):
        b, c, h, w = x.shape
        if self.conv_mask is not None:
            attn = torch.softmax(self.conv_mask(x).reshape(b, h * w), -1)
            context = torch.einsum("bn,bcn->bc", attn,
                                   x.to(attn.dtype).reshape(b, c, h * w))
        else:
            context = x.mean((2, 3))
        context = context[:, :, None, None]
        out = x
        if self.channel_mul_conv is not None:
            out = out * torch.sigmoid(self.channel_mul_conv(context))
        if self.channel_add_conv is not None:
            out = out + self.channel_add_conv(context)
        return out


def position_embedding(h: int, w: int, h_kv: int, w_kv: int, q_stride: int,
                       kv_stride: int, feat_dim: int, magnitude: float,
                       device=None, wave_length: float = 1000.0):
    """Sinusoidal embeddings of the x and y differences between query and
    key/value positions, in f32 on ``device``: ((w, w_kv, feat_dim / 2),
    (h, h_kv, feat_dim / 2)), sines then cosines."""
    def ar(n, s):
        return torch.arange(n, dtype=torch.float32, device=device)[:, None] * s

    h_diff = (ar(h, q_stride)[:, None, :] - ar(h_kv, kv_stride)[None]) * magnitude
    w_diff = (ar(w, q_stride)[:, None, :] - ar(w_kv, kv_stride)[None]) * magnitude
    feat_range = torch.arange(feat_dim // 4, dtype=torch.float32,
                              device=device)
    dim_mat = torch.pow(torch.tensor(wave_length, device=device),
                        (4.0 / feat_dim) * feat_range)
    ex = torch.cat([torch.sin(w_diff / dim_mat), torch.cos(w_diff / dim_mat)], 2)
    ey = torch.cat([torch.sin(h_diff / dim_mat), torch.cos(h_diff / dim_mat)], 2)
    return ex, ey


def _local_mask(h, w, h_kv, w_kv, spatial_range, kv_stride, device):
    """(h * w, h_kv * w_kv) True where key (ky, kx) lies within
    ``spatial_range`` of query (iy, ix), in key/value cells."""
    def ok(n, m):
        i = torch.arange(n, device=device)[:, None]
        k = torch.arange(m, device=device)[None, :]
        return ((k >= torch.div(i - spatial_range, kv_stride,
                                rounding_mode="floor"))
                & (k <= torch.div(i + spatial_range + 1, kv_stride,
                                  rounding_mode="floor")))

    oy, ox = ok(h, h_kv), ok(w, w_kv)
    return (oy[:, None, :, None] & ox[None, :, None, :]).reshape(
        h * w, h_kv * w_kv)


class GeneralizedAttention(nn.Module):
    """Empirical attention ("An Empirical Study of Spatial Attention
    Mechanisms"): the energy of each (query, key/value) pair sums the terms
    that ``attention_type``'s four bits select (appearance-appearance,
    appearance-position, bias-appearance, bias-position), a softmax over
    the key/value map (strided by ``kv_stride``; queries by ``q_stride``),
    optionally limited to ``spatial_range``, then ``gamma`` times the
    projected output plus the input. Names as mmdet's: ``query_conv``,
    ``key_conv``, ``value_conv``, ``appr_geom_fc_x``/``_y``, ``appr_bias``,
    ``geom_bias``, ``proj_conv``, ``gamma``."""

    def __init__(self, in_dim: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: float = 1.0, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = "1111",
                 device=None):
        super().__init__()
        at = tuple(bool(int(c)) for c in attention_type)
        self.at = at
        self.num_heads = nh = num_heads
        self.qk_dim = qk = in_dim // nh
        self.v_dim = in_dim // nh
        self.pe_dim = (position_embedding_dim if position_embedding_dim > 0
                       else in_dim)
        self.spatial_range = spatial_range
        self.position_magnitude = position_magnitude
        self.kv_stride = kv_stride
        self.q_stride = q_stride
        kw = dict(bias=False, device=device)
        self.query_conv = (Conv(in_dim, nh * qk, 1, 1, 0, **kw)
                           if at[0] or at[1] else None)
        self.key_conv = (Conv(in_dim, nh * qk, 1, 1, 0, **kw)
                         if at[0] or at[2] else None)
        self.value_conv = Conv(in_dim, nh * self.v_dim, 1, 1, 0, **kw)
        geom = at[1] or at[3]
        self.appr_geom_fc_x = (nn.Linear(self.pe_dim // 2, nh * qk, **kw)
                               if geom else None)
        self.appr_geom_fc_y = (nn.Linear(self.pe_dim // 2, nh * qk, **kw)
                               if geom else None)
        stdv = 1.0 / math.sqrt(qk * 2)

        def uniform_bias():
            return nn.Parameter(torch.empty(nh * qk, device=device)
                                .uniform_(-stdv, stdv))

        self.appr_bias = uniform_bias() if at[2] else None
        self.geom_bias = uniform_bias() if at[3] else None
        self.proj_conv = Conv(nh * self.v_dim, in_dim, 1, 1, 0, device=device)
        self.gamma = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        at, nh, qk = self.at, self.num_heads, self.qk_dim
        b, _, H, W = x.shape
        qs, ks = self.q_stride, self.kv_stride
        x_q = x[:, :, ::qs, ::qs] if qs > 1 else x
        x_kv = x[:, :, ::ks, ::ks] if ks > 1 else x
        h, w = x_q.shape[-2:]
        h_kv, w_kv = x_kv.shape[-2:]

        def heads(t, d):  # (B, nh * d, y, x) -> (B, y * x, nh, d)
            return t.reshape(b, nh, d, -1).permute(0, 3, 1, 2)

        q = heads(self.query_conv(x_q), qk) if at[0] or at[1] else None
        k = heads(self.key_conv(x_kv), qk) if at[0] or at[2] else None
        if at[1] or at[3]:
            ex, ey = position_embedding(h, w, h_kv, w_kv, qs, ks, self.pe_dim,
                                        self.position_magnitude, x.device)
            pf_x = (F.linear(ex, self.appr_geom_fc_x.weight)
                    .reshape(w, w_kv, nh, qk) / math.sqrt(2))
            pf_y = (F.linear(ey, self.appr_geom_fc_y.weight)
                    .reshape(h, h_kv, nh, qk) / math.sqrt(2))

        energy = torch.zeros((b, nh, h * w, h_kv * w_kv), dtype=torch.float32,
                             device=x.device)
        if at[0]:
            qq = q + self.appr_bias.reshape(1, 1, nh, qk) if at[2] else q
            energy = energy + torch.einsum("bqnd,bknd->bnqk", qq, k)
        elif at[2]:
            eb = torch.einsum("nd,bknd->bnk", self.appr_bias.reshape(nh, qk), k)
            energy = energy + eb[:, :, None, :]
        if at[1]:
            qg = q + self.geom_bias.reshape(1, 1, nh, qk) if at[3] else q
            qg = qg.reshape(b, h, w, nh, qk)
            e_x = torch.einsum("bhwnd,wvnd->bnhwv", qg, pf_x)
            e_y = torch.einsum("bhwnd,hund->bnhwu", qg, pf_y)
            energy = energy + (e_x[:, :, :, :, None, :]
                               + e_y[:, :, :, :, :, None]).reshape(
                b, nh, h * w, h_kv * w_kv)
        elif at[3]:  # bias-position only
            gb = self.geom_bias.reshape(nh, qk)
            e_x = torch.einsum("wvnd,nd->nwv", pf_x, gb)
            e_y = torch.einsum("hund,nd->nhu", pf_y, gb)
            energy = energy + (e_x[None, :, None, :, None, :]
                               + e_y[None, :, :, None, :, None]).reshape(
                1, nh, h * w, h_kv * w_kv)
        if self.spatial_range >= 0:
            allowed = _local_mask(h, w, h_kv, w_kv, self.spatial_range, ks,
                                  x.device)
            energy = energy.masked_fill(~allowed, float("-inf"))
        attn = torch.softmax(energy, -1)
        v = heads(self.value_conv(x_kv), self.v_dim)
        out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(
            b, h, w, nh * self.v_dim).permute(0, 3, 1, 2)
        out = self.proj_conv(out)
        if qs > 1:  # each strided query's output covers its qs x qs cell
            out = out.repeat_interleave(qs, 2).repeat_interleave(qs, 3)[
                :, :, :H, :W]
        return self.gamma * out + x
