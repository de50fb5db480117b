"""build_detector(cfg, train_cfg, test_cfg, device): a detector from a
config's ``model`` dict through the DETECTORS registry (the port of
vps_tpu/models/builder.py)."""

from __future__ import annotations

from typing import Any, Dict

from reference.vpsref.registry import DETECTORS, build_from_cfg


def build_detector(model_cfg: Dict[str, Any], train_cfg=None, test_cfg=None,
                   device="cuda"):
    """``model_cfg['type']`` names the class (PanopticFuseTrack when it has
    none): the three panoptic detectors (a tower set to None, such as
    ``track_head`` or ``extra_neck``, is left out), the two-stage and
    cascade R-CNNs, or the ``HTC`` alias."""
    import reference.vpsref.models.detectors  # noqa: F401  (registers every type)

    kind = dict(model_cfg).get("type", "PanopticFuseTrack")
    if kind not in DETECTORS:
        raise ValueError(f"unknown detector type {kind!r}; the port has "
                         f"{sorted(DETECTORS)}")
    return build_from_cfg(model_cfg, DETECTORS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg,
                               device=device), "PanopticFuseTrack")
