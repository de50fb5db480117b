"""Port parity, SSD's extra augmentations: vps_torch/data/extra_aug.py held
bit for bit to vps_tpu/data/extra_aug.py as
tests/test_fcos_ssd_train.py::test_extra_aug_family drives it (the
photometric distortion, Expand and the MinIoU crop composed, seeds 0-5),
and the HSV conversions on the same image.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several); numpy only, well under a second.
"""

import numpy as np

import vps_tpu.data.extra_aug as jaug

import vps_torch.data.extra_aug as taug
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_extra_aug_bit_equal_to_vps_tpu():
    rng = np.random.RandomState(0)
    img = rng.rand(40, 60, 3).astype(np.float32) * 255
    hsv = taug.rgb_to_hsv(img)
    np.testing.assert_array_equal(hsv, jaug.rgb_to_hsv(img))
    np.testing.assert_array_equal(taug.hsv_to_rgb(hsv), jaug.hsv_to_rgb(hsv))
    boxes = np.asarray([[5, 5, 20, 25], [30, 10, 55, 35]], np.float32)
    labels = np.asarray([1, 2], np.int32)
    cfg = dict(
        photo_metric_distortion=dict(brightness_delta=32,
                                     contrast_range=(0.5, 1.5),
                                     saturation_range=(0.5, 1.5),
                                     hue_delta=18),
        expand=dict(mean=(123.675, 116.28, 103.53), ratio_range=(1, 3)),
        random_crop=dict(min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                         min_crop_size=0.3))
    port, ref = taug.ExtraAugmentation(**cfg), jaug.ExtraAugmentation(**cfg)
    shapes = set()
    for seed in range(6):
        got = port(img, boxes, labels, np.random.RandomState(seed))
        want = ref(img, boxes, labels, np.random.RandomState(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        shapes.add(got[0].shape)
    assert len(shapes) > 1  # the seeds take different branches
