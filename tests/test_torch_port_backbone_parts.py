"""Port parity, the backbones' parts: ``deform_conv2d_grouped`` (1, 2 and 4
deformable groups, with and without a mask, stride 2), GCNet's
``ContextBlock`` (att and avg pooling, add and mul fusion), the empirical
``GeneralizedAttention`` (each of its attention types, plain, with a
``spatial_range`` and with ``q_stride`` 2), ``HRFPN``, ``roi_pool``,
``deform_roi_pool`` and ``ConvWS``, each against vps_tpu's on the CPU in
f32: within 1e-5 of the largest value, the blocks on weights that make
them more than an identity (``backbone_parity.fill_backbone``).

Cheap tests; the backbones' and detectors' own files hold the whole paths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vps_tpu.models.layers import ConvWS as JConvWS
from vps_tpu.models.plugins import ContextBlock as JContextBlock
from vps_tpu.models.plugins import GeneralizedAttention as JAttention
from vps_tpu.ops.deform_conv import deform_conv2d_grouped as j_grouped
from vps_tpu.ops.roi_pool import deform_roi_pool as j_deform_roi_pool
from vps_tpu.ops.roi_pool import roi_pool as j_roi_pool

from backbone_parity import (
    assert_close_to_largest,
    backbone_pair,
    port_state,
    variables,
)
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.layers import ConvWS
from vps_torch.models.plugins import ContextBlock, GeneralizedAttention
from vps_torch.ops.deform_conv import deform_conv2d, deform_conv2d_grouped
from vps_torch.ops.roi_pool import deform_roi_pool, roi_pool

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_grouped_matches_jax(groups, modulated):
    rng = np.random.RandomState(groups + 10 * modulated)
    x = rng.randn(1, 9, 10, 8).astype(np.float32)
    off = (1.5 * rng.randn(1, 5, 5, groups * 18)).astype(np.float32)
    w = (rng.randn(6, 8, 3, 3) / 8).astype(np.float32)
    mask = (rng.rand(1, 5, 5, groups * 9).astype(np.float32) if modulated
            else None)
    want = j_grouped(jnp.asarray(x), jnp.asarray(off),
                     jnp.asarray(w.transpose(2, 3, 1, 0)), groups, stride=2,
                     padding=1, mask=None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else _t(mask)
    got = deform_conv2d_grouped(_t(x), _t(off), _t(w), groups, stride=2,
                                padding=1, mask=tm)
    assert_close_to_largest([got.numpy()], [np.asarray(want)], TOL)
    if groups == 1:  # deform_conv2d itself, bit for bit
        assert torch.equal(got, deform_conv2d(_t(x), _t(off), _t(w), stride=2,
                                              padding=1, mask=tm))


def _plugin_pair(jmod, port, x, seed):
    """A plugin of vps_tpu's and the port's on the same seeded weights
    (loaded through state_dict_from_jax as block layer1.0's
    ``name``), NHWC x. Returns (want, got) as NHWC numpy."""
    v = variables(jmod, jnp.asarray(x), seed)
    want = np.asarray(jax.jit(lambda v: jmod.apply(v, jnp.asarray(x)))(v))
    name = type(port).__name__
    name = "context_block" if name == "ContextBlock" else "gen_attention_block"
    port.load_state_dict(port_state(("backbone", "layer1_0", name), v,
                                    f"backbone.layer1.0.{name}"), strict=True)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return want, got


@pytest.mark.parametrize("pooling", ["att", "avg"])
@pytest.mark.parametrize("fusion", [("channel_add",), ("channel_mul",),
                                    ("channel_add", "channel_mul")])
def test_context_block_matches_jax(pooling, fusion):
    x = np.random.RandomState(3).randn(2, 6, 5, 32).astype(np.float32)
    kw = dict(ratio=0.25, pooling_type=pooling, fusion_types=fusion)
    want, got = _plugin_pair(JContextBlock(**kw), ContextBlock(32, **kw), x, 1)
    assert_close_to_largest([got], [want], TOL)
    # not an identity: the transform moved every sample
    assert np.abs(want - x).max() > 1e-2


def test_context_block_layer_norm_epsilon():
    """A small input (x 1e-3): the LayerNorm's variance (~1e-6) is then of
    the order of its epsilon, so flax's 1e-6 and torch's 1e-5 part by far
    more than the bar."""
    x = 1e-3 * np.random.RandomState(5).randn(1, 6, 5, 32).astype(np.float32)
    want, got = _plugin_pair(JContextBlock(ratio=0.25),
                             ContextBlock(32, ratio=0.25), x, 4)
    assert_close_to_largest([got - x], [want - x], TOL)


@pytest.mark.parametrize("attention_type", ["1111", "1000", "0100", "0010",
                                            "0001"])
@pytest.mark.parametrize("spatial_range,q_stride", [(-1, 1), (1, 1), (-1, 2)])
def test_generalized_attention_matches_jax(attention_type, spatial_range,
                                           q_stride):
    x = np.random.RandomState(4).randn(1, 7, 9, 16).astype(np.float32)
    kw = dict(spatial_range=spatial_range, num_heads=2, kv_stride=2,
              q_stride=q_stride, attention_type=attention_type)
    want, got = _plugin_pair(JAttention(in_dim=16, **kw),
                             GeneralizedAttention(16, **kw), x, 2)
    assert_close_to_largest([got], [want], TOL)
    assert np.abs(want - x).max() > 1e-2  # gamma is not zero


def test_hrfpn_matches_jax():
    shapes = [(1, 16, 16, 8), (1, 8, 8, 16), (1, 4, 4, 32), (1, 2, 2, 64)]
    want, got, _ = backbone_pair(
        "HRFPN", "HRFPN", dict(in_channels=(8, 16, 32, 64), out_channels=16,
                               num_outs=5), shapes, neck=True)
    assert [g.shape[1] for g in got] == [16, 8, 4, 2, 1]
    assert_close_to_largest(got, want, TOL)


def _rois():
    return np.asarray([[2.0, 3.0, 30.0, 25.0], [10.5, 0.0, 55.0, 40.0],
                       [0.0, 0.0, 8.0, 8.0], [40.0, 20.0, 47.0, 50.0]],
                      np.float32)


def test_roi_pool_matches_jax():
    rng = np.random.RandomState(5)
    feat = rng.randn(12, 14, 6).astype(np.float32)
    valid = np.asarray([1, 1, 0, 1], np.float32)
    want = j_roi_pool(jnp.asarray(feat), jnp.asarray(_rois()), 0.25, 3,
                      valid=jnp.asarray(valid))
    got = roi_pool(_t(feat), _t(_rois()), 0.25, 3, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_offsets", [False, True])
def test_deform_roi_pool_matches_jax(with_offsets):
    rng = np.random.RandomState(6)
    feat = rng.randn(12, 14, 20).astype(np.float32)
    off = (rng.randn(4, 3, 3, 2).astype(np.float32) if with_offsets
           else None)
    want = j_deform_roi_pool(jnp.asarray(feat), jnp.asarray(_rois()),
                             None if off is None else jnp.asarray(off), 0.25, 3)
    got = deform_roi_pool(_t(feat), _t(_rois()),
                          None if off is None else _t(off), 0.25, 3)
    assert_close_to_largest([got.numpy()], [np.asarray(want)], TOL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 2)])
def test_conv_ws_matches_jax(stride, dilation):
    rng = np.random.RandomState(7)
    x = rng.randn(1, 11, 10, 5).astype(np.float32)
    jmod = JConvWS(6, 3, stride, dilation, dilation)
    v = variables(jmod, jnp.asarray(x), 3)
    v["params"]["kernel"] = v["params"]["kernel"] + 0.05  # a non-zero mean
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = ConvWS(5, 6, 3, stride, dilation, dilation)
    with torch.no_grad():
        mod.weight.copy_(_t(v["params"]["kernel"]).permute(3, 2, 0, 1))
        mod.bias.copy_(_t(v["params"]["bias"]))
        got = mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert_close_to_largest([got], [want], TOL)
