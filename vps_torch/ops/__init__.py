"""Ops of the port. ``correlation`` (forward and backward) and
``deform_conv2d_windowed`` are hand-written CUDA kernels (``csrc/correlation.cu``,
``csrc/deform_conv_windowed.cu``) with their plain PyTorch versions beside
them; the others are plain PyTorch tensor code, as their JAX counterparts
are XLA compositions."""

from vps_torch.ops.correlation import (
    correlation,
    correlation_backward,
    correlation_backward_reference,
    correlation_reference,
)
from vps_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_multilevel,
    deform_conv2d_windowed,
    deform_conv2d_windowed_reference,
)
from vps_torch.ops.nms import nms
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.ops.warp import channel_norm, flow_warp, resample2d

__all__ = [
    "channel_norm",
    "correlation",
    "correlation_backward",
    "correlation_backward_reference",
    "correlation_reference",
    "deform_conv2d",
    "deform_conv2d_multilevel",
    "deform_conv2d_windowed",
    "deform_conv2d_windowed_reference",
    "flow_warp",
    "multilevel_roi_align",
    "nms",
    "resample2d",
]
