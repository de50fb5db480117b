"""Detectors of the port."""

from vps_torch.models.detectors.panoptic import (
    PanopticFuse,
    PanopticFuseTrack,
    PanopticTrack,
    build_detector,
    make_frame_step,
    predict_video,
    random_init_,
    run_video_streams,
)
from vps_torch.models.detectors.panoptic_ops import TrackState, empty_track_state

__all__ = ["PanopticFuse", "PanopticFuseTrack", "PanopticTrack",
           "TrackState", "build_detector",
           "empty_track_state", "make_frame_step", "predict_video",
           "random_init_", "run_video_streams"]
