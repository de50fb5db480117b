"""The port's data pipeline: COCO-json index, the Cityscapes-VPS and VIPER
video datasets, the image-level COCO, Cityscapes, VOC and WIDER Face
datasets, numpy/cv2 train and test pipelines, image corruptions, the
per-epoch loader and the synthetic fixture generator (copies of the JAX
package's ``data`` modules)."""

from vps_torch.data.coco import CocoIndex  # noqa: F401
from vps_torch.data.dataset import (  # noqa: F401
    DATASETS,
    CityscapesDataset,
    CityscapesVPSDataset,
    CocoDataset,
    ViperDataset,
    build_dataset,
)
from vps_torch.data.loader import build_loader  # noqa: F401
from vps_torch.data.xml_style import (  # noqa: F401
    VOCDataset,
    WIDERFaceDataset,
    XMLDataset,
)
