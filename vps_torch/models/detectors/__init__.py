"""Detectors of the port."""

from vps_torch.models.detectors.panoptic import (
    PanopticFuseTrack,
    predict_video,
    random_init_,
)
from vps_torch.models.detectors.panoptic_ops import TrackState, empty_track_state

__all__ = ["PanopticFuseTrack", "TrackState", "empty_track_state",
           "predict_video", "random_init_"]
