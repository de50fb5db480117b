"""Port parity, the ResNet's plugins: an R-50 with GCNet's ContextBlock
(ratio 1/16) in stages 2-4 and the empirical attention ('1111', 8 heads,
kv_stride 2) on every block of stages 3 and 4 (the mmdetection v1.0
gcnet and empirical_attention configs' placement), against vps_tpu's on a
seeded 64x64 image, with non-zero ``gamma`` and ContextBlock weights
(``fill_backbone``): every stage's output within 1e-4 of its largest value.
"""

from backbone_parity import assert_close_to_largest, backbone_pair
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_resnet_gcb_and_attention_match_jax():
    kw = dict(depth=50, gcb=dict(ratio=1.0 / 16.0),
              stage_with_gcb=(False, True, True, True),
              gen_attention=dict(spatial_range=-1, num_heads=8,
                                 attention_type="1111", kv_stride=2),
              stage_with_gen_attention=((), (), (0, 1, 2, 3, 4, 5), (0, 1, 2)))
    want, got, port = backbone_pair("ResNet", "ResNet", kw)
    blocks = [b for i in range(1, 5) for b in getattr(port, f"layer{i}")]
    assert sum(b.context_block is not None for b in blocks) == 13
    assert sum(b.gen_attention_block is not None for b in blocks) == 9
    assert [g.shape[-1] for g in got] == [256, 512, 1024, 2048]
    assert_close_to_largest(got, want, 1e-4)
