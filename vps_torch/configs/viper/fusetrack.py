# VPSNet-FuseTrack on VIPER (day split): the reference recipe, the same dicts
# as configs/viper/fusetrack.py, read through the port's zoo. The reference
# trains on VIPER first and warm-starts Cityscapes-VPS from this model.
# VIPER: 23 semantic classes, 10 things (num_classes=11 with background);
# thing label i is semantic class i + 12.
from vps_torch import zoo

model = zoo.fusetrack_model_cfg(depth=50)
model["panoptic"].update(num_things_classes=10, num_classes=23)
model["bbox_head"]["num_classes"] = 11
model["mask_head"]["num_classes"] = 11

train_cfg = zoo.fusetrack_train_cfg()
train_cfg["class_mapping"] = {i: i + 12 for i in range(1, 11)}
test_cfg = zoo.fusetrack_test_cfg()
test_cfg["class_mapping"] = {i: i + 12 for i in range(1, 11)}

dataset_type = "ViperDataset"
data_root = "data/viper_vps/"

data = dict(
    imgs_per_gpu=1,
    workers_per_gpu=2,
    train=dict(
        type=dataset_type,
        ann_file=data_root + "instances_train_05_viper_coco.json",
        img_prefix=data_root + "train/img/",
        ref_prefix=data_root + "train/img/",
        seg_prefix=data_root + "train/labelmap/",
        ref_ann_file=data_root + "instances_train_05_viper_coco.json",
        offsets=[-2, -1, 1, 2],
    ),
    test=dict(
        type=dataset_type,
        ann_file=data_root + "instances_val_day_01_viper_coco.json",
        img_prefix=data_root + "val_day/img/",
        ref_prefix=data_root + "val_day/img/",
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
work_dir = "./work_dirs/viper/fusetrack"
load_from = None
resume_from = None
