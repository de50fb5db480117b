"""Port parity, ops: every vps_torch op against its vps_tpu counterpart on
the same seeded numpy inputs, on the CPU (where the correlation and windowed
DCN wrappers take their plain versions). The `cuda`-marked tests hold the
CUDA kernels against their plain versions and need a card.

Tolerances: f32 paths agree to summation order (atol 1e-5 on O(1) values);
index-valued results (NMS keep sets, sample positions) must be identical.
The windowed DCN's gradients are checked in a one-test file of their own,
``test_torch_port_windowed_grads.py`` (pytest-xdist's loadfile scheduler
queues a one-test file after the files with several).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vps_tpu.ops import correlation as jax_correlation
from vps_tpu.ops import (
    channel_norm as jax_channel_norm,
    flow_warp as jax_flow_warp,
    multilevel_roi_align as jax_multilevel_roi_align,
    nms as jax_nms,
    resample2d as jax_resample2d,
)
from vps_tpu.ops.deform_conv import (
    deform_conv2d as jax_deform_conv2d,
    deform_conv2d_multilevel as jax_deform_conv2d_multilevel,
    deform_conv2d_windowed as jax_deform_conv2d_windowed,
)

from vps_torch import ops

T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """One jitted reference per function and static arguments, shared by the
    file's tests: a compile is cheaper than op-by-op dispatch."""
    return jax.jit(fn, static_argnums=static)


# one compile for every seed and threshold (the threshold is traced)
_jnms = jax.jit(lambda b, s, thr, v: jax_nms(b, s, thr, valid=v))


@pytest.mark.parametrize("shape,md,s2", [
    ((2, 12, 17, 32), 4, 1),   # LiteFlowNetCorr geometry, ragged width
    ((1, 24, 30, 16), 20, 2),  # FlowNetC geometry (441 channels)
])
def test_correlation_f32(shape, md, s2):
    rng = np.random.RandomState(0)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    want = np.asarray(_jit(jax_correlation, 2, 3)(jnp.asarray(f1),
                                                  jnp.asarray(f2), md, s2))
    got = ops.correlation(T(f1), T(f2), md, s2).numpy()
    steps = 2 * (md // s2) + 1
    assert got.shape == shape[:3] + (steps * steps,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_correlation_bf16():
    """bf16 inputs. _correlation_xla rounds each product to bf16 before its
    f32 mean (vps_tpu/ops/correlation.py:125); the port keeps products in
    f32. Both round the result to bf16. Tolerance: 2 bf16 ulps of the value
    (rtol 2^-7) plus 2^-8 * mean|f1| * mean|f2| for the product roundings."""
    rng = np.random.RandomState(1)
    shape = (1, 10, 13, 64)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    want = np.asarray(_jit(jax_correlation, 2, 3)(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16), 4, 1)
        .astype(jnp.float32))
    got = ops.correlation(T(f1).bfloat16(), T(f2).bfloat16(), 4, 1)
    assert got.dtype == torch.bfloat16
    atol = 2.0 ** -8 * np.abs(f1).mean() * np.abs(f2).mean()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=atol)


def test_correlation_rejects_bad_input():
    a = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        ops.correlation(a, torch.zeros(1, 4, 5, 8), 2, 1)
    with pytest.raises(TypeError):
        ops.correlation(a.half(), a.half(), 2, 1)


def test_kernel_ablate_texts_are_in_the_source():
    """Each ablation of ``vps_torch.kernel_ablate`` changes exactly one spot
    of the f32 correlation kernel's source (it refuses to run otherwise)."""
    from vps_torch import kernel_ablate
    from vps_torch.ops import cuda_build

    source = (cuda_build.CSRC / "correlation.cu").read_text()
    for name, change in kernel_ablate.ABLATIONS.items():
        if change is not None:
            assert source.count(change[0]) == 1, name


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
def test_flow_warp(sampling):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 14, 24).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 9, 14, 2)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jax_flow_warp, sampling=sampling))(jnp.asarray(x), jnp.asarray(flow)))
    got = ops.flow_warp(T(x), T(flow), sampling=sampling).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resample2d_and_channel_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 11, 13, 3).astype(np.float32)
    flow = rng.uniform(-4, 4, (1, 11, 13, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_resample2d)(jnp.asarray(x),
                                              jnp.asarray(flow)))
    got = ops.resample2d(T(x), T(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ops.channel_norm(T(x)).numpy(),
                               np.asarray(jax.jit(jax_channel_norm)(
                                   jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
def test_deform_conv2d_multilevel(sampling):
    rng = np.random.RandomState(4)
    shapes = [(12, 16), (6, 8), (3, 4)]
    cin, cout = 16, 8
    xs = [rng.randn(1, h, w, cin).astype(np.float32) for h, w in shapes]
    offs = [rng.uniform(-2.5, 2.5, (1, h, w, 18)).astype(np.float32)
            for h, w in shapes]
    w_hwio = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    want = jax.jit(functools.partial(
        jax_deform_conv2d_multilevel, padding=1, sampling=sampling))(
        [jnp.asarray(x) for x in xs], [jnp.asarray(o) for o in offs],
        jnp.asarray(w_hwio))
    got = ops.deform_conv2d_multilevel(
        [T(x) for x in xs], [T(o) for o in offs],
        T(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))), padding=1,
        sampling=sampling)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=1e-5)


def _hwio(w_torch):
    return np.ascontiguousarray(w_torch.transpose(2, 3, 1, 0))


@pytest.mark.parametrize("case", ["bilinear", "nearest", "mask_bias",
                                  "stride2_dilation2"])
def test_deform_conv2d(case):
    """Single-level DCN against JAX deform_conv2d, f32 atol 1e-5 (sum
    order). Offsets reach past the map's edge."""
    rng = np.random.RandomState(11)
    stride, dilation = (2, 2) if case == "stride2_dilation2" else (1, 1)
    b, h, w, cin, cout = 2, 9, 11, 6, 5
    ho = (h + 2 - dilation * 2 - 1) // stride + 1
    wo = (w + 2 - dilation * 2 - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = rng.uniform(-3, 3, (b, ho, wo, 18)).astype(np.float32)
    weight = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    mask = bias = None
    if case == "mask_bias":
        mask = rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32)
        bias = rng.randn(cout).astype(np.float32)
    sampling = "nearest" if case == "nearest" else "bilinear"
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    want = jax.jit(functools.partial(
        jax_deform_conv2d, stride=stride, padding=1, dilation=dilation,
        sampling=sampling))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(_hwio(weight)),
        bias=opt(bias, jnp.asarray), mask=opt(mask, jnp.asarray))
    got = ops.deform_conv2d(T(x), T(off), T(weight), bias=opt(bias, T),
                            stride=stride, padding=1, dilation=dilation,
                            mask=opt(mask, T), sampling=sampling)
    assert got.dtype == torch.float32 and got.shape == (b, ho, wo, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _windowed_inputs(rng, shape, cout, scale):
    b, h, w, cin = shape
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (rng.randn(b, h, w, 18) * scale).astype(np.float32)
    weight = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    return x, off, weight


@pytest.mark.parametrize("scale", [1.5, 12.0])
def test_deform_conv2d_windowed_f32(scale):
    """Against JAX deform_conv2d_windowed (its XLA path on the CPU): offsets
    N(0, 1.5) mostly inside the window, and the same x8, mostly clamped to
    +-4. f32 atol 1e-5 (sum order)."""
    x, off, weight = _windowed_inputs(np.random.RandomState(12), (2, 10, 13, 8),
                                      6, scale)
    want = _jit(jax_deform_conv2d_windowed, 3, 4)(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(_hwio(weight)), 1, 4)
    got = ops.deform_conv2d_windowed(T(x), T(off), T(weight), 1, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_deform_conv2d_windowed_bf16():
    """bf16 x and weight (the half-flow semantic head). Both sides round the
    mixed samples to bf16 before an f32-accumulated product and return f32,
    so they differ by summation order and the odd bf16 rounding flip:
    max |diff| <= 2^-8 * max |ref|."""
    x, off, weight = _windowed_inputs(np.random.RandomState(13), (1, 12, 16, 32),
                                      16, 1.5)
    want = np.asarray(_jit(jax_deform_conv2d_windowed, 3, 4)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(off),
        jnp.asarray(_hwio(weight), jnp.bfloat16), 1, 4).astype(jnp.float32))
    got = ops.deform_conv2d_windowed(T(x).bfloat16(), T(off),
                                     T(weight).bfloat16(), 1, 4)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_deform_conv2d_windowed_rejects_bad_input():
    x, off, w = torch.zeros(1, 4, 5, 8), torch.zeros(1, 4, 5, 18), torch.zeros(6, 8, 3, 3)
    with pytest.raises(TypeError):  # x and weight dtypes differ
        ops.deform_conv2d_windowed(x.bfloat16(), off, w)
    with pytest.raises(TypeError):  # half precision
        ops.deform_conv2d_windowed(x.half(), off, w.half())
    with pytest.raises(TypeError):  # offsets not f32
        ops.deform_conv2d_windowed(x, off.double(), w)
    with pytest.raises(ValueError):  # rank
        ops.deform_conv2d_windowed(x[0], off[0], w)
    with pytest.raises(ValueError):  # offsets of another map
        ops.deform_conv2d_windowed(x, torch.zeros(1, 4, 4, 18), w)
    with pytest.raises(ValueError):  # devices differ
        ops.deform_conv2d_windowed(x, off.to("meta"), w)


@pytest.mark.parametrize("cout,cin,bn", [(40, 48, 128), (130, 24, 256)])
def test_fused_windowed_weight_layout(cout, cin, bn):
    """The fused windowed kernel's weight slabs: (K, ceil(Cin/64), Cout padded
    to the tile, 64), zero past Cout and Cin, chunk c of row r at c ^ (r % 8),
    and kept on the weight until it changes in place."""
    from vps_torch.ops.deform_conv import _fused_weight

    weight = T(np.random.RandomState(15).randn(cout, cin, 3, 3)).bfloat16()
    w = _fused_weight(weight, bn)
    nck, cpad = -(-cin // 64), -(-cout // bn) * bn
    assert tuple(w.shape) == (9, nck, cpad, 64) and w.is_contiguous()
    want = torch.zeros(9, cpad, nck * 64, dtype=torch.bfloat16)
    want[:, :cout, :cin] = weight.permute(2, 3, 0, 1).reshape(9, cout, cin)
    for ck in range(nck):
        for r in range(cpad):
            for c in range(8):
                pos = (c ^ (r % 8)) * 8
                assert torch.equal(w[:, ck, r, pos:pos + 8],
                                   want[:, r, ck * 64 + c * 8:ck * 64 + c * 8 + 8])
    assert _fused_weight(weight, bn) is w
    weight.mul_(2)
    assert _fused_weight(weight, bn) is not w


def test_windowed_weight_cast_kept():
    """The windowed head keeps its bf16 weight between frames (so the fused
    kernel's layout, cached on it, is built once), makes it anew when the
    parameter changes, and casts afresh, with its gradient, under autograd."""
    from vps_torch.models.panoptic_fpn import DeformConvWithOffset

    m = DeformConvWithOffset(8, 6, dcn_window=2)
    with torch.inference_mode():
        w1 = m._windowed_weight(torch.bfloat16)
        assert m._windowed_weight(torch.bfloat16) is w1
    with torch.no_grad():
        m.conv.weight.mul_(2)
        w2 = m._windowed_weight(torch.bfloat16)
    assert w2 is not w1
    assert torch.equal(w2, m.conv.weight.detach().bfloat16())
    assert m._windowed_weight(torch.bfloat16).requires_grad


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
def test_multilevel_roi_align(sampling):
    rng = np.random.RandomState(5)
    strides = [4, 8, 16, 32]
    shapes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = [rng.randn(h, w, 8).astype(np.float32) for h, w in shapes]
    boxes = [
        [10.0, 12.0, 40.0, 50.0],      # level 0
        [0.0, 0.0, 111.0, 111.0],      # sqrt(area) = 112: on the 0/1 boundary
        [20.0, 5.0, 243.0, 228.0],     # sqrt(area) = 224: on the 1/2 boundary
        [30.0, 30.0, 85.0, 85.0],      # sqrt(area) = 56: level 0 exactly
        [-20.0, -30.0, 15.0, 10.0],    # partly off-map (negative)
        [150.0, 100.0, 260.0, 190.0],  # past the right/bottom edge
        [400.0, 300.0, 420.0, 330.0],  # wholly off-map
        [5.0, 5.0, 4.0, 4.0],          # degenerate (x2 < x1)
    ]
    rand = rng.uniform(0, 150, (8, 2))
    wh = rng.uniform(2, 160, (8, 2))
    boxes += np.concatenate([rand, rand + wh], 1).tolist()
    rois = np.asarray(boxes, np.float32)
    valid = np.ones(len(rois), bool)
    valid[3] = False
    for out_size, sn in ((7, 2), (14, 1)):
        want = jax_multilevel_roi_align(
            [jnp.asarray(f) for f in feats], jnp.asarray(rois), strides,
            out_size, sn, valid=jnp.asarray(valid), sampling=sampling)
        got = ops.multilevel_roi_align(
            [T(f) for f in feats], T(rois), strides, out_size, sn,
            valid=T(valid), sampling=sampling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_identical_keep_sets(seed):
    """Same survivors as the JAX fixpoint, including exact score ties
    (stable descending order) and invalid slots."""
    rng = np.random.RandomState(10 + seed)
    n = 96
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[10:20] = boxes[0]  # duplicated boxes
    scores = rng.choice(np.linspace(0.1, 0.9, 7), n).astype(np.float32)  # ties
    valid = rng.rand(n) > 0.2
    for thr in (0.3, 0.5, 0.7):
        want = np.asarray(_jnms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                jnp.asarray(valid)))
        got = ops.nms(T(boxes), T(scores), thr, valid=T(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[~valid].any()


@pytest.mark.cuda
def test_correlation_kernel_matches_plain_on_card():
    """The CUDA kernels against correlation_reference on the card: f32 (the
    register-tiled SIMT kernel) within 1e-5 (sum order); bf16 (the
    tensor-core kernel) within one output ulp (rtol 2^-7) + 1e-6. Both
    call-site geometries (and the f32 train crop's), ragged ones (C = 30 is
    staged element by element), FlowNetC's geometry with W not a multiple of
    either kernel's block, stride 3 and 4, C > 256 (f1 staged with every
    unit; C = 300 element by element), stride 5 and 6 (residue groups),
    B = 3, and H < md (every displacement row partly outside the map)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, md, s2 in [((1, 32, 64, 256), 4, 1), ((1, 16, 32, 256), 20, 2),
                          ((2, 37, 53, 96), 4, 1), ((2, 37, 53, 30), 6, 2),
                          ((1, 64, 100, 256), 20, 2), ((1, 9, 50, 64), 6, 3),
                          ((1, 12, 70, 40), 80, 4), ((1, 12, 70, 300), 4, 1),
                          ((1, 8, 40, 512), 6, 2), ((1, 10, 90, 40), 12, 5),
                          ((2, 7, 75, 64), 20, 6), ((3, 3, 45, 64), 4, 1),
                          ((1, 5, 70, 256), 20, 2), ((3, 9, 50, 300), 6, 3),
                          ((1, 56, 104, 256), 20, 2), ((1, 50, 100, 256), 4, 1)]:
        for dt, rtol, atol in ((torch.float32, 0, 1e-5),
                               (torch.bfloat16, 2.0 ** -7, 1e-6)):
            f1 = torch.randn(shape, generator=gen, device="cuda").to(dt)
            f2 = torch.randn(shape, generator=gen, device="cuda").to(dt)
            got = ops.correlation(f1, f2, md, s2)
            want = ops.correlation_reference(f1, f2, md, s2)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)


@pytest.mark.cuda
def test_deform_conv2d_windowed_kernel_matches_plain_on_card():
    """The CUDA kernels against deform_conv2d_windowed_reference on the card:
    f32 (TF32 off; tap products, then the mix kernel) within 1e-4 * max|ref|
    + 1e-5 (sum order); bf16 (the fused gather-mix-product kernel, whose A
    tile holds the plain version's bf16 samples bit for bit) within 2^-16 *
    max|ref| (f32 sum order only). Ragged shapes, Cout that takes
    element-wise stores, both output-channel tiles (Cout 64 and 130), Cin 20
    (element-wise corner reads), offsets in and past the window, integer
    offsets, a grid small enough to split."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, w, cin, cout), window, scale in [
            ((1, 32, 64, 64, 64), 4, 1.5), ((1, 32, 64, 64, 32), 4, 12.0),
            ((2, 37, 53, 48, 40), 4, 1.5), ((2, 37, 53, 48, 40), 2, 1.5),
            ((1, 9, 11, 16, 6), 4, 3.0), ((3, 20, 35, 24, 130), 3, 2.0),
            ((2, 13, 21, 20, 12), 4, 1.5)]:
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
        off = torch.randn(b, h, w, 18, generator=gen, device="cuda") * scale
        weight = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / 20
        for offset in (off, off.round()):
            for dt, rel, atol in ((torch.float32, 1e-4, 1e-5),
                                  (torch.bfloat16, 2.0 ** -16, 0.0)):
                got = ops.deform_conv2d_windowed(x.to(dt), offset,
                                                 weight.to(dt), 1, window)
                want = ops.deform_conv2d_windowed_reference(
                    x.to(dt), offset, weight.to(dt), 1, window)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                assert err <= rel * float(want.abs().max()) + atol, (dt, err)
