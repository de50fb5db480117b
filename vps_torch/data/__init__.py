"""The port's data pipeline: COCO-json index, Cityscapes-VPS dataset,
numpy/cv2 train and test pipelines, the per-epoch loader and the synthetic
fixture generator (copies of the JAX package's ``data`` modules)."""

from vps_torch.data.coco import CocoIndex  # noqa: F401
from vps_torch.data.dataset import CityscapesVPSDataset, build_dataset  # noqa: F401
from vps_torch.data.loader import build_loader  # noqa: F401
