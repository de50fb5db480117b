"""FlowNet2 (port of vps_tpu/models/flow/flownet2.py): the frozen cascade
FlowNetC -> FlowNetS -> FlowNetS, FlowNetSD in parallel, FlowNetFusion.
Parameter names are the FlowNet2 checkpoint's (``flownetc.conv1.0.weight``,
``flownetc.predict_flow6.weight``, ``flownetc.deconv5.0.weight``...).

Compute dtype is an explicit constructor argument (the JAX package publishes
it through a module global instead): every conv with more than two output
channels runs in it, flow-prediction convs and flow upsamplers stay f32.
``FlowNet2`` and ``TinyFlowNet`` take and return NHWC, as in JAX; the subnets
run NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from reference.vpsref.models.layers import (
    Conv,
    ConvTranspose,
    leaky_relu,
    resize_bilinear,
    resize_nearest,
)
from reference.vpsref.ops import channel_norm, correlation, resample2d

# torch ConvTranspose2d(4, 2, 1) as the reference builds it
TorchConvTranspose = ConvTranspose


def _conv(cin, cout, k=3, s=1, dtype=None, device=None):
    """submodules.conv: Sequential(Conv2d, LeakyReLU(0.1)) -> key '<name>.0'."""
    return nn.Sequential(Conv(cin, cout, k, s, (k - 1) // 2, dtype=dtype,
                              device=device), nn.LeakyReLU(0.1))


def _iconv(cin, cout, dtype=None, device=None):
    """submodules.i_conv: Sequential(Conv2d) with no activation."""
    return nn.Sequential(Conv(cin, cout, 3, 1, 1, dtype=dtype, device=device))


def _predict(cin, device=None):
    return Conv(cin, 2, 3, 1, 1, device=device)  # f32: flow regression


def _deconv(cin, cout, dtype=None, device=None):
    return nn.Sequential(TorchConvTranspose(cin, cout, 4, 2, 1, dtype=dtype,
                                            device=device), nn.LeakyReLU(0.1))


def _up(bias=True, device=None):
    return TorchConvTranspose(2, 2, 4, 2, 1, bias=bias, device=device)


class _Decoder(nn.Module):
    """The shared FlowNetC/FlowNetS decoder (levels 6 -> 2)."""

    def _decode(self, c6, skips, inter=False):
        flow = self.predict_flow6(c6)
        feat = c6
        for lvl, skip in zip((5, 4, 3, 2), skips):
            up = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flow)
            d = getattr(self, f"deconv{lvl}")(feat)
            # mixed bf16/f32 parts promote to f32, as jnp.concatenate does
            feat = torch.cat([skip, d, up], 1)
            x = getattr(self, f"inter_conv{lvl}")(feat) if inter else feat
            flow = getattr(self, f"predict_flow{lvl}")(x)
        return flow

    def _build_decoder(self, skip_ch, dtype, device, up_bias=True,
                       inter=False):
        self.predict_flow6 = _predict(1024, device)
        cin = 1024
        for lvl, (sc, dc) in zip((5, 4, 3, 2),
                                 zip(skip_ch, (512, 256, 128, 64))):
            setattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}",
                    _up(up_bias, device))
            setattr(self, f"deconv{lvl}", _deconv(cin, dc, dtype, device))
            cat = sc + dc + 2
            if inter:
                setattr(self, f"inter_conv{lvl}", _iconv(cat, dc, dtype, device))
                setattr(self, f"predict_flow{lvl}", _predict(dc, device))
            else:
                setattr(self, f"predict_flow{lvl}", _predict(cat, device))
            cin = cat


class FlowNetC(_Decoder):
    """Two-stream encoder + 441-channel cost volume (md 20, stride 2)."""

    def __init__(self, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(3, 64, 7, 2, **kw)
        self.conv2 = _conv(64, 128, 5, 2, **kw)
        self.conv3 = _conv(128, 256, 5, 2, **kw)
        self.conv_redir = _conv(256, 32, 1, 1, **kw)
        self.conv3_1 = _conv(473, 256, **kw)
        self.conv4 = _conv(256, 512, 3, 2, **kw)
        self.conv4_1 = _conv(512, 512, **kw)
        self.conv5 = _conv(512, 512, 3, 2, **kw)
        self.conv5_1 = _conv(512, 512, **kw)
        self.conv6 = _conv(512, 1024, 3, 2, **kw)
        self.conv6_1 = _conv(1024, 1024, **kw)
        self._build_decoder((512, 512, 256, 128), dtype, device)

    def forward(self, x1, x2):
        c2a = self.conv2(self.conv1(x1))
        c3a = self.conv3(c2a)
        c3b = self.conv3(self.conv2(self.conv1(x2)))
        corr = correlation(c3a.permute(0, 2, 3, 1).contiguous(),
                           c3b.permute(0, 2, 3, 1).contiguous(), 20, 2)
        corr = leaky_relu(corr.permute(0, 3, 1, 2))
        x = torch.cat([self.conv_redir(c3a), corr], 1)  # 473
        c3_1 = self.conv3_1(x)
        c4 = self.conv4_1(self.conv4(c3_1))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self._decode(c6, (c5, c4, c3_1, c2a))


class FlowNetS(_Decoder):
    """Plain encoder-decoder on 12 input channels; flow upsamplers carry no
    bias (FlowNetS.py)."""

    def __init__(self, input_channels=12, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(input_channels, 64, 7, 2, **kw)
        self.conv2 = _conv(64, 128, 5, 2, **kw)
        self.conv3 = _conv(128, 256, 5, 2, **kw)
        self.conv3_1 = _conv(256, 256, **kw)
        self.conv4 = _conv(256, 512, 3, 2, **kw)
        self.conv4_1 = _conv(512, 512, **kw)
        self.conv5 = _conv(512, 512, 3, 2, **kw)
        self.conv5_1 = _conv(512, 512, **kw)
        self.conv6 = _conv(512, 1024, 3, 2, **kw)
        self.conv6_1 = _conv(1024, 1024, **kw)
        self._build_decoder((512, 512, 256, 128), dtype, device, up_bias=False)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self._decode(c6, (c5, c4, c3, c2))


class FlowNetSD(_Decoder):
    """Small-displacement net with inter_convs."""

    def __init__(self, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = _conv(6, 64, **kw)
        self.conv1 = _conv(64, 64, 3, 2, **kw)
        self.conv1_1 = _conv(64, 128, **kw)
        self.conv2 = _conv(128, 128, 3, 2, **kw)
        self.conv2_1 = _conv(128, 128, **kw)
        self.conv3 = _conv(128, 256, 3, 2, **kw)
        self.conv3_1 = _conv(256, 256, **kw)
        self.conv4 = _conv(256, 512, 3, 2, **kw)
        self.conv4_1 = _conv(512, 512, **kw)
        self.conv5 = _conv(512, 512, 3, 2, **kw)
        self.conv5_1 = _conv(512, 512, **kw)
        self.conv6 = _conv(512, 1024, 3, 2, **kw)
        self.conv6_1 = _conv(1024, 1024, **kw)
        self._build_decoder((512, 512, 256, 128), dtype, device, inter=True)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2_1(self.conv2(self.conv1_1(self.conv1(c0))))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self._decode(c6, (c5, c4, c3, c2), inter=True)


class FlowNetFusion(nn.Module):
    """Shallow fusion net on 11 input channels."""

    def __init__(self, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = _conv(11, 64, **kw)
        self.conv1 = _conv(64, 64, 3, 2, **kw)
        self.conv1_1 = _conv(64, 128, **kw)
        self.conv2 = _conv(128, 128, 3, 2, **kw)
        self.conv2_1 = _conv(128, 128, **kw)
        self.predict_flow2 = _predict(128, device)
        self.upsampled_flow2_to_1 = _up(True, device)
        self.deconv1 = _deconv(128, 32, **kw)
        self.inter_conv1 = _iconv(162, 32, **kw)
        self.predict_flow1 = _predict(32, device)
        self.upsampled_flow1_to_0 = _up(True, device)
        self.deconv0 = _deconv(162, 16, **kw)
        self.inter_conv0 = _iconv(82, 16, **kw)
        self.predict_flow0 = _predict(16, device)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        cat1 = torch.cat([c1, self.deconv1(c2),
                          self.upsampled_flow2_to_1(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        cat0 = torch.cat([c0, self.deconv0(cat1),
                          self.upsampled_flow1_to_0(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(cat0))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class FlowNet2(nn.Module):
    """Full cascade. img1, img2: (B, H, W, 3) RGB in [0, 255], H and W
    divisible by 64 -> flow (B, H, W, 2) in pixels."""

    RGB_MAX = 255.0
    DIV_FLOW = 20.0

    def __init__(self, compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=compute_dtype, device=device)
        self.flownetc = FlowNetC(**kw)
        self.flownets_1 = FlowNetS(**kw)
        self.flownets_2 = FlowNetS(**kw)
        self.flownets_d = FlowNetSD(**kw)
        self.flownetfusion = FlowNetFusion(**kw)

    def forward(self, img1, img2):
        rgb_mean = torch.stack([img1, img2], 1).mean(dim=(1, 2, 3),
                                                      keepdim=True)[:, 0]
        x1 = (img1 - rgb_mean) / self.RGB_MAX
        x2 = (img2 - rgb_mean) / self.RGB_MAX
        h, w = x1.shape[1:3]
        div = self.DIV_FLOW

        def up(flow2, mode):
            resize = resize_bilinear if mode == "bilinear" else resize_nearest
            return _nhwc(resize(flow2, (h, w)))

        def refine_input(flow):
            res = resample2d(x2, flow)
            return torch.cat([x1, x2, res, flow / div,
                              channel_norm(x1 - res)], -1)

        flow_c = up(self.flownetc(_nchw(x1), _nchw(x2)) * div, "bilinear")
        flow_s1 = up(self.flownets_1(_nchw(refine_input(flow_c))) * div,
                     "bilinear")
        flow_s2 = up(self.flownets_2(_nchw(refine_input(flow_s1))) * div,
                     "nearest")
        flow_sd = up(self.flownets_d(_nchw(torch.cat([x1, x2], -1))) / div,
                     "nearest")
        concat3 = torch.cat([
            x1,
            flow_sd,
            flow_s2,
            channel_norm(flow_sd),
            channel_norm(flow_s2),
            channel_norm(x1 - resample2d(x2, flow_sd)),
            channel_norm(x1 - resample2d(x2, flow_s2)),
        ], -1)  # 11 channels
        return _nhwc(self.flownetfusion(_nchw(concat3)))


class TinyFlowNet(nn.Module):
    """FlowNet2 stand-in for tests (panoptic.py TinyFlowNet): same
    (img1, img2 in [0, 255], NHWC) -> (B, H, W, 2) interface."""

    def __init__(self, device=None):
        super().__init__()
        self.c1 = Conv(6, 16, 3, 2, 1, device=device)
        self.c2 = Conv(16, 16, 3, 2, 1, device=device)
        self.pred = Conv(16, 2, 3, 1, 1, device=device)

    def forward(self, img1, img2):
        x = _nchw(torch.cat([img1, img2], -1) / 255.0)
        h, w = x.shape[-2:]
        x = torch.relu(self.c1(x))
        x = torch.relu(self.c2(x))
        return _nhwc(resize_bilinear(self.pred(x), (h, w)))
