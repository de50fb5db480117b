"""Shared pieces of the backbone parity tests
(``tests/test_torch_port_backbone_*.py``): tests/test_two_stage.py's tiny
HRNet, the weights, and one backbone (or neck, or plugin) of vps_tpu's and
the port's on the same seeded weights and input.

Weights: ``zoo_parity.fill``'s (kernels N(0, 1/fan_in), the last BN of each
residual branch x0.2), with the parameters that make a fresh block an
identity given seeded non-zero values: the attention's ``gamma`` (zero in
JAX and mmdet) 0.5 + 0.1 z, its biases 0.1 z; the ContextBlock's last conv
keeps ``fill``'s N(0, 1/fan_in) (zero in JAX and mmdet), and the DCN's
weight (a parameter of the block, which ``fill`` would treat as a bias)
N(0, 1/fan_in). The DCN offsets come from ``fill``'s offset conv: about a
pixel, off the integer positions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models import build_detector as _jax_registers  # noqa: F401
from vps_tpu.registry import BACKBONES as JBACKBONES
from vps_tpu.registry import NECKS as JNECKS

from test_two_stage import tiny_cfg
from zoo_parity import MASK, fill

import vps_torch.models.detectors  # noqa: F401  (registers every module)
from vps_torch.convert import state_dict_from_jax
from vps_torch.registry import BACKBONES, NECKS

# tests/test_two_stage.py's hr_tiny
HR_TINY = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(1,), num_channels=(16,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(1, 1), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)),
)


def hrnet_cfg():
    """tests/test_two_stage.py's HRNet -> HRFPN -> Faster R-CNN."""
    return tiny_cfg(backbone=dict(type="HRNet", extra=HR_TINY),
                    neck=dict(type="HRFPN", in_channels=(8, 16, 32, 64),
                              out_channels=32, num_outs=5))


def plugins_cfg():
    """A tiny Mask R-CNN on an R-50 with the plugins as the mmdetection
    v1.0 configs place them: DCN v1 and a ContextBlock (ratio 1/16) in
    stages 2-4, the '1111' attention (8 heads, kv_stride 2) on every block
    of stages 3 and 4, ``frozen_stages=1``; a 32-wide FPN and heads."""
    return tiny_cfg(
        backbone=dict(type="ResNet", depth=50, frozen_stages=1,
                      out_indices=(0, 1, 2, 3),
                      dcn=dict(modulated=False, deformable_groups=1,
                               fallback_on_stride=False),
                      stage_with_dcn=(False, True, True, True),
                      gcb=dict(ratio=1.0 / 16.0),
                      stage_with_gcb=(False, True, True, True),
                      gen_attention=dict(spatial_range=-1, num_heads=8,
                                         attention_type="1111", kv_stride=2),
                      stage_with_gen_attention=((), (), (0, 1, 2, 3, 4, 5),
                                                (0, 1, 2))),
        neck=dict(type="FPN", in_channels=(256, 512, 1024, 2048),
                  out_channels=32, num_outs=5), **MASK)


def fill_backbone(tree, rng):
    """``fill``'s values, then the identity-at-init parameters and the DCN
    weight re-drawn as the module docstring says (sorted key order)."""
    out = fill(tree, rng)

    def walk(t, path=()):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            z = rng.standard_normal(v.shape, dtype=np.float32)
            if k == "kernel" and path[-2:] in (("channel_add_conv_0", "Conv_0"),
                                                ("channel_mul_conv_0", "Conv_0")):
                # the context transform's first conv: a unit spread into
                # its LayerNorm (fill's ~0.1 would scale the LayerNorm's
                # gradient by ~10 and its rounding with it)
                t[k] = 10.0 * v
            elif k == "gamma":
                t[k] = 0.5 + 0.1 * z
            elif k in ("appr_bias", "geom_bias"):
                t[k] = 0.1 * z
            elif k == "conv2_weight":
                t[k] = z / np.float32(np.sqrt(np.prod(v.shape[:-1])))

    walk(out)
    return out


def variables(module, x, seed=0):
    """Seeded variables of a flax ``module`` for input ``x`` (eval_shape of
    init, filled by fill_backbone; no init is run)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)
    return {k: fill_backbone(v, rng) for k, v in shapes.items()}


def port_state(prefix, v, torch_prefix):
    """The port's state_dict of the flax variables ``v`` of one module that
    sits at flax path ``prefix`` (a tuple) in a detector, whose port module
    sits at ``torch_prefix``; its keys relative to that module."""
    def nest(tree):
        for name in reversed(prefix):
            tree = {name: tree}
        return tree

    sd = state_dict_from_jax(nest(v["params"]),
                             nest(v["batch_stats"]) if "batch_stats" in v
                             else None)
    head = torch_prefix + "."
    assert all(k.startswith(head) for k in sd), sorted(sd)[:3]
    return {k[len(head):]: t for k, t in sd.items()}


def backbone_pair(jax_kind, port_kind, kw, shape=(1, 64, 64, 3), seed=0,
                  neck=False):
    """vps_tpu's registered backbone (or neck) ``jax_kind`` and the port's
    ``port_kind`` with the config ``kw`` on the same seeded weights and a
    seeded input of ``shape`` (NHWC; a neck takes a list of shapes).
    Returns (JAX outputs, the port's as NHWC numpy, the port module)."""
    rng = np.random.RandomState(seed + 100)
    shapes = shape if neck else [shape]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jmod = (JNECKS if neck else JBACKBONES).get(jax_kind)(**kw)
    jx = [jnp.asarray(x) for x in xs]
    arg = tuple(jx) if neck else jx[0]
    v = variables(jmod, arg, seed)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(v, arg)
    port = (NECKS if neck else BACKBONES)[port_kind](device="cpu", **kw)
    top = "neck" if neck else "backbone"
    port.load_state_dict(port_state((top,), v, top), strict=True)
    tx = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
    with torch.no_grad():
        got = port(tx if neck else tx[0])
    return ([np.asarray(a) for a in want],
            [g.permute(0, 2, 3, 1).numpy() for g in got], port)


def assert_close_to_largest(got, want, tol):
    """Each output within ``tol`` of its largest magnitude."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        scale = np.abs(w).max()
        assert scale > 0
        err = np.abs(g - w).max()
        assert err <= tol * scale, (err, scale)
