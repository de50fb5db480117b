"""Port parity, ResNeXt-50 32x4d (mmdet's ResNeXt: grouped 3x3 convs of
width int(planes * 4 / 64) * 32) against vps_tpu's on a seeded 64x64
image: every stage's output within 1e-4 of its largest value.
"""

from backbone_parity import assert_close_to_largest, backbone_pair
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_resnext50_matches_jax():
    want, got, port = backbone_pair(
        "ResNeXt", "ResNeXt", dict(depth=50, groups=32, base_width=4))
    assert port.layer1[0].conv2.groups == 32
    assert tuple(port.layer1[0].conv2.weight.shape) == (128, 4, 3, 3)
    assert [g.shape[-1] for g in got] == [256, 512, 1024, 2048]
    assert_close_to_largest(got, want, 1e-4)
