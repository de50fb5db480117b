"""Ops of the port. A frozen copy of the port's ops, each
its plain PyTorch version on every device."""

from reference.vpsref.ops.correlation import correlation, correlation_reference
from reference.vpsref.ops.deform_conv import deform_conv2d_multilevel
from reference.vpsref.ops.nms import nms
from reference.vpsref.ops.roi_align import multilevel_roi_align
from reference.vpsref.ops.warp import channel_norm, flow_warp, resample2d


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
