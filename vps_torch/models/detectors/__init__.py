"""Detectors of the port: the VPSNet family (panoptic.py), the two-stage
R-CNNs (two_stage.py) and the cascades (cascade.py), all registered in
``vps_torch.registry.DETECTORS`` and built by ``build_detector``."""

from vps_torch.models.builder import build_detector
from vps_torch.models.detectors.cascade import CascadeRCNN, HybridTaskCascade
from vps_torch.models.detectors.panoptic import (
    PanopticFuse,
    PanopticFuseTrack,
    PanopticTrack,
    make_frame_step,
    predict_video,
    random_init_,
    run_video_streams,
)
from vps_torch.models.detectors.panoptic_ops import TrackState, empty_track_state
from vps_torch.models.detectors.two_stage import (
    RPN,
    DoubleHeadRCNN,
    FasterRCNN,
    FastRCNN,
    GridRCNN,
    MaskRCNN,
    MaskScoringRCNN,
)

__all__ = ["CascadeRCNN", "DoubleHeadRCNN", "FastRCNN", "FasterRCNN",
           "GridRCNN", "HybridTaskCascade", "MaskRCNN", "MaskScoringRCNN",
           "PanopticFuse", "PanopticFuseTrack", "PanopticTrack", "RPN",
           "TrackState", "build_detector", "empty_track_state",
           "make_frame_step", "predict_video", "random_init_",
           "run_video_streams"]
