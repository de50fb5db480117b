"""Ops of the port. ``correlation`` is a hand-written CUDA kernel
(``csrc/correlation.cu``) with its plain PyTorch version beside it; the
others are plain PyTorch tensor code, as their JAX counterparts are XLA
compositions."""

from vps_torch.ops.correlation import correlation, correlation_reference
from vps_torch.ops.deform_conv import deform_conv2d_multilevel
from vps_torch.ops.nms import nms
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.ops.warp import channel_norm, flow_warp, resample2d

__all__ = [
    "channel_norm",
    "correlation",
    "correlation_reference",
    "deform_conv2d_multilevel",
    "flow_warp",
    "multilevel_roi_align",
    "nms",
    "resample2d",
]
