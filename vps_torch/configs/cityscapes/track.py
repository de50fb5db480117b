# VPSNet-Track ablation (tracking, no flow fusion), mmdet's
# configs/cityscapes/track.py: the recipe and data of fusetrack.py.
# The model dicts merge into the base's, so the fuse neck is set to None
# (a key left out would keep the base's).
_base_ = "fusetrack.py"

from vps_torch import zoo

model = zoo.fusetrack_model_cfg(depth=50)
model["type"] = "PanopticTrack"
model["extra_neck"] = None
work_dir = "./work_dirs/cityscapes_vps/track"
