"""The port's data pipeline: COCO-json index, Cityscapes-VPS and VIPER datasets,
numpy/cv2 train and test pipelines, the per-epoch loader and the synthetic
fixture generator (copies of the JAX package's ``data`` modules)."""

from vps_torch.data.coco import CocoIndex  # noqa: F401
from vps_torch.data.dataset import (  # noqa: F401
    DATASETS,
    CityscapesVPSDataset,
    ViperDataset,
    build_dataset,
)
from vps_torch.data.loader import build_loader  # noqa: F401
