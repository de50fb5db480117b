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
    deform_conv2d_grouped,
    deform_conv2d_multilevel,
    deform_conv2d_windowed,
    deform_conv2d_windowed_reference,
)
from vps_torch.ops.nms import nms
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.ops.roi_pool import deform_roi_pool, roi_pool
from vps_torch.ops.warp import channel_norm, flow_warp, resample2d


def launch_counts():
    """The hand-written kernels' launch counts in this process, by kernel:
    the correlation's routes (``corr_bf16_tc``, ``corr_f32``),
    ``corr_backward`` and ``dcw_fused``. Each wrapper counts where it
    launches its kernel and nowhere else."""
    return dict(correlation.route_launches,
                corr_backward=correlation_backward.launches,
                dcw_fused=deform_conv2d_windowed.launches)


__all__ = [
    "channel_norm",
    "correlation",
    "correlation_backward",
    "correlation_backward_reference",
    "correlation_reference",
    "deform_conv2d",
    "deform_conv2d_grouped",
    "deform_conv2d_multilevel",
    "deform_conv2d_windowed",
    "deform_conv2d_windowed_reference",
    "deform_roi_pool",
    "flow_warp",
    "launch_counts",
    "multilevel_roi_align",
    "nms",
    "resample2d",
    "roi_pool",
]
