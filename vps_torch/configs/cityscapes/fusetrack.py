# VPSNet-FuseTrack on Cityscapes-VPS: the reference recipe, the same dicts
# as configs/cityscapes/fusetrack.py, read through the port's zoo.
from vps_torch import zoo

model = zoo.fusetrack_model_cfg(depth=50)
train_cfg = zoo.fusetrack_train_cfg()
test_cfg = zoo.fusetrack_test_cfg()

dataset_type = "CityscapesVPSDataset"
data_root = "data/cityscapes_vps/"
semantic2label = {**{i: i for i in range(19)}, -1: 255, 255: 255}

data = dict(
    imgs_per_gpu=1,
    workers_per_gpu=2,
    train=dict(
        type="RepeatDataset",
        times=8,
        dataset=dict(
            type=dataset_type,
            ann_file=data_root + "instances_train_city_vps_rle.json",
            img_prefix=data_root + "train/img/",
            ref_prefix=data_root + "train/img/",
            seg_prefix=data_root + "train/labelmap/",
            ref_ann_file=data_root + "instances_train_city_vps_rle.json",
            offsets=[-1, 1],
            semantic2label=semantic2label,
        ),
    ),
    val=dict(
        type=dataset_type,
        ann_file=data_root + "instances_val_city_vps_rle.json",
        img_prefix=data_root + "val/img/",
    ),
    test=dict(
        type=dataset_type,
        ann_file=data_root + "im_all_info_val_city_vps.json",
        img_prefix=data_root + "val/img_all/",
        ref_prefix=data_root + "val/img_all/",
        nframes_span_test=30,
        test_mode=True,
    ),
)

optimizer = dict(type="SGD", lr=0.005, momentum=0.9, weight_decay=0.0001)
optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
lr_config = dict(policy="step", warmup="linear", warmup_iters=500,
                 warmup_ratio=1.0 / 3, step=[8, 11])
checkpoint_config = dict(interval=4)
log_config = dict(interval=10)
total_epochs = 12
log_level = "INFO"
work_dir = "./work_dirs/cityscapes_vps/fusetrack"
load_from = None
resume_from = None
