# VPSNet-FuseTrack fast-inference preset: the recipe and data of
# fusetrack.py with zoo.fast_overrides applied (nearest-neighbour DCN and
# warp sampling, sample_num=1 RoIAlign, quarter-res FlowNet2 input).
_base_ = "fusetrack.py"

from vps_torch import zoo

model = zoo.fast_overrides(zoo.fusetrack_model_cfg(depth=50))
work_dir = "./work_dirs/cityscapes_vps/fusetrack_fast"
