"""Detectors of the frozen reference: PanopticFuseTrack (panoptic.py) and
Mask R-CNN (two_stage.py), registered in
``reference.vpsref.registry.DETECTORS`` and built by ``build_detector``."""

from reference.vpsref.models.builder import build_detector
from reference.vpsref.models.detectors.panoptic import (
    PanopticFuseTrack,
    predict_video,
)
from reference.vpsref.models.detectors.panoptic_ops import TrackState, empty_track_state
from reference.vpsref.models.detectors.two_stage import MaskRCNN

__all__ = [
    "MaskRCNN",
    "PanopticFuseTrack",
    "TrackState",
    "build_detector",
    "empty_track_state",
    "predict_video",
]
