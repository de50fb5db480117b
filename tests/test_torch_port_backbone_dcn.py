"""Port parity, the ResNet's deformable conv2 (mmdet's ``dcn`` key): an
R-50 cut to two stages (as tests/test_resnet_plugins.py cuts it) with DCN
v1 in stage 2, and with modulated DCN in 4 deformable groups, against
vps_tpu's on a seeded 64x64 image, and modulated DCN with both stages
unstrided and dilated 2 (the ResNet's ``strides`` and ``dilations``): both
stages' outputs within 1e-4 of their largest value, the offsets about a
pixel (``fill_backbone``).
"""

from backbone_parity import assert_close_to_largest, backbone_pair
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

CUT = dict(depth=50, num_stages=2, strides=(1, 2), dilations=(1, 1),
           out_indices=(0, 1), stage_with_dcn=(False, True))


def test_resnet_dcn_matches_jax():
    for dcn, over in ((dict(modulated=False, deformable_groups=1), {}),
                      (dict(modulated=True, deformable_groups=4), {}),
                      # dilated and unstrided, as a DC5 trunk: the plain
                      # conv2 and the DCN (and its offset conv) dilated
                      (dict(modulated=True, deformable_groups=1),
                       dict(strides=(1, 1), dilations=(2, 2)))):
        want, got, port = backbone_pair("ResNet", "ResNet",
                                        dict(CUT, dcn=dcn, **over))
        side = 16 if over else 8
        assert [g.shape for g in got] == [(1, 16, 16, 256),
                                          (1, side, side, 512)]
        block = port.layer2[0]
        assert block.conv2_offset.weight.shape[0] == dcn[
            "deformable_groups"] * (27 if dcn["modulated"] else 18)
        assert tuple(block.conv2.weight.shape) == (128, 128, 3, 3)
        assert_close_to_largest(got, want, 1e-4)
