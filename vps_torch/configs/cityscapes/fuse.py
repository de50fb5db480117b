# VPSNet-Fuse ablation (flow fusion, no tracking), mmdet's
# configs/cityscapes/fuse.py: the recipe and data of fusetrack.py.
# The model dicts merge into the base's, so the track head is set to None
# (a key left out would keep the base's).
_base_ = "fusetrack.py"

from vps_torch import zoo

model = zoo.fusetrack_model_cfg(depth=50)
model["type"] = "PanopticFuse"
model["track_head"] = None
work_dir = "./work_dirs/cityscapes_vps/fuse"
